"""The benchmark's shared machinery: discovery, generation, driving, tracing, checks."""
