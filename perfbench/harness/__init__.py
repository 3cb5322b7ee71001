"""The harness: traffic, weights, the served window, traces, the output check."""
