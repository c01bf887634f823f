"""The general harness: cell lookup, inputs, traffic, the window, tracing,
the work arithmetic and the result line."""
