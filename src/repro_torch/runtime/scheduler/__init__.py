"""Continuous-batching scheduler package of the port.

Counterpart of ``repro.runtime.scheduler``, split the same way:

* ``types`` — ``Request`` / ``Completion`` / ``SchedulerConfig`` /
  ``SchedEvent`` / ``SlotFailure`` and the admission-time validator;
* ``allocator`` — the refcounted block pool of the paged layout;
* ``layouts`` — ``SlottedLayout`` / ``PagedLayout`` KV surgery;
* ``prefix_pool`` — ``VictimCache``: retention of released prefix chains
  (tenant quotas, weighted-LRU eviction) and its checkpoint save and
  restore;
* ``prefill`` — one-shot, prefix-resume and chunked prompt admission;
* ``units`` — ``ExecutionCore`` on modeled per-unit clocks;
* ``core`` — ``ContinuousScheduler``, the loop tying them together.
"""
from repro_torch.runtime.policies import sample_tokens
from repro_torch.runtime.scheduler.allocator import BlockAllocator
from repro_torch.runtime.scheduler.core import (ContinuousScheduler,
                                                device_step_lock)
from repro_torch.runtime.scheduler.layouts import PagedLayout, SlottedLayout
from repro_torch.runtime.scheduler.prefix_pool import (VictimCache,
                                                       restore_victim_cache,
                                                       save_victim_cache)
from repro_torch.runtime.scheduler.types import (COUNTER_KEYS, FINISH_REASONS,
                                                 Completion, Request,
                                                 SchedEvent, SchedulerConfig,
                                                 SlotFailure,
                                                 validate_request_fits)
from repro_torch.runtime.scheduler.units import (DecodeExecutor,
                                                 ExecutionCore,
                                                 PrefillExecutor,
                                                 UnitExecutor, UnitSpec)

__all__ = [
    "Request", "Completion", "SchedulerConfig", "SchedEvent", "SlotFailure",
    "SlottedLayout", "PagedLayout", "BlockAllocator", "ContinuousScheduler",
    "device_step_lock",
    "sample_tokens",
    "validate_request_fits", "FINISH_REASONS", "COUNTER_KEYS",
    "UnitSpec", "UnitExecutor", "PrefillExecutor", "DecodeExecutor",
    "ExecutionCore",
    "VictimCache", "save_victim_cache", "restore_victim_cache",
]
