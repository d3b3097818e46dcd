"""Continuous-batching serving engine over paged KV caches (the port of
``repro.serving``): the allocator and scheduler are copies of the JAX
package's, so scheduling decisions are the JAX engine's decisions; the
device half runs the port's model on the card."""

from repro_torch.serving.engine import EngineControlPlane, ServingEngine
from repro_torch.serving.paged_cache import (HostSpill, PagedKVAllocator,
                                             arena_pages, pages_for)
from repro_torch.serving.scheduler import (ContinuousScheduler, PrefillChunk,
                                           Request, summarize)

__all__ = ["ContinuousScheduler", "EngineControlPlane", "HostSpill",
           "PagedKVAllocator", "PrefillChunk", "Request", "ServingEngine",
           "arena_pages", "pages_for", "summarize"]
