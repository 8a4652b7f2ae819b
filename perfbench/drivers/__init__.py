"""One module per kind of system entry a cell drives, named by the
configuration's ``driver`` key."""
