"""Public serving surface of the port.

Counterpart of ``repro.serving``: the import path for everything a
serving caller needs — the policy-configured ``Engine`` facade, its
config, the request/handle/completion lifecycle types, the HTTP front
end, the observability pieces, and the closed set of ``finish_reason``
values::

    from repro_torch.serving import Engine, EngineConfig, Request

    eng = Engine(cfg, model, EngineConfig(admission="fifo")).start()
    handle = eng.submit(Request(id=0, prompt=prompt, max_new_tokens=32))
    for tok in handle.stream():
        ...

The Edge-PRUNE partitioned engine (``PartitionedServeEngine``: prefill
through the model's actor graph split by a mapping) is re-exported here
from ``repro_torch.runtime.serving``, where the deprecated
``ServeEngine`` shim stays, as in the reference. Hierarchical serving
(``runtime.escalation``) is re-exported too: ``TieredEngine`` fronts a
local ``Engine`` plus a remote tier behind a transport, with a durable
on-disk escalation journal.
"""
from repro_torch.runtime.engine import Engine, EngineConfig, RequestHandle
from repro_torch.runtime.escalation import (EscalationJournal, FlakyTransport,
                                            HttpTransport, InProcessTransport,
                                            JournalReplayer, LinkDown,
                                            TieredConfig, TieredEngine,
                                            TieredHandle)
from repro_torch.runtime.observability import (MetricsRegistry, Observability,
                                               Tracer, parse_prometheus,
                                               validate_chrome_trace)
from repro_torch.runtime.scheduler import (FINISH_REASONS, Completion,
                                           Request, SlotFailure)
from repro_torch.runtime.server import EngineServer, ServerConfig
from repro_torch.runtime.serving import PartitionedServeEngine

__all__ = [
    "Engine",
    "EngineConfig",
    "Request",
    "RequestHandle",
    "Completion",
    "SlotFailure",
    "FINISH_REASONS",
    "EngineServer",
    "ServerConfig",
    "PartitionedServeEngine",
    "TieredEngine",
    "TieredConfig",
    "TieredHandle",
    "EscalationJournal",
    "JournalReplayer",
    "InProcessTransport",
    "HttpTransport",
    "FlakyTransport",
    "LinkDown",
    "Observability",
    "MetricsRegistry",
    "Tracer",
    "parse_prometheus",
    "validate_chrome_trace",
]
