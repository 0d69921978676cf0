"""Open-system walk serving: continuous request arrival over a persistent
walk stream (`repro_torch.walker.WalkStream` — ring-buffer slot
reclamation), with optional online chunk adaptation
(`repro_torch.serve.scheduler.HopsController`)."""
from repro_torch.serve.scheduler import AdaptationEvent, HopsController
from repro_torch.serve.service import WalkRequest, WalkService
from repro_torch.serve.workload import OpenLoad, run_open_load

__all__ = ["AdaptationEvent", "HopsController", "WalkRequest",
           "WalkService", "OpenLoad", "run_open_load"]
