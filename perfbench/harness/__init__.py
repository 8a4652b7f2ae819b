"""The general harness: cell loading, timing, tracing, the result line."""
