"""Continuous-batching confidential serving over a slot-recycled paged KV
cache. ``Request``/``ServerStats`` are re-exported from ``runtime.server``
so both schedulers share one surface."""
from repro_torch.runtime.server import Request, ServerStats, WaveServer
from repro_torch.runtime.serving.load import (shared_prefix_requests,
                                              zipf_requests)
from repro_torch.runtime.serving.paged_cache import PagePool
from repro_torch.runtime.serving.scheduler import ContinuousServer

__all__ = ["Request", "ServerStats", "WaveServer", "PagePool",
           "ContinuousServer", "zipf_requests", "shared_prefix_requests"]
