"""Launchers: the trainer (:mod:`.train`)."""
