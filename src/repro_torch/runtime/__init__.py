"""Training runtime: the generic loop and the producer/consumer pipelined
loop."""
from repro_torch.runtime import train_loop
