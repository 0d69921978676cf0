"""Training runtime: the producer/consumer pipelined loop."""
