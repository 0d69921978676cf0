"""Training runtime: the generic loop, the producer/consumer pipelined
loop and elastic remesh."""
from repro_torch.runtime import elastic, train_loop
