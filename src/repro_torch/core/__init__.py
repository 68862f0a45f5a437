"""VR-PRUNE dataflow model of computation + Edge-PRUNE toolchain, copied
from ``repro.core`` for the port (the modules import nothing of either
framework; the port keeps its own copy so that it imports no module of
``repro``).

Public API::

    from repro_torch.core import (
        Graph, Actor, Port, Fifo, ActorType, PortDir, Dpg,
        analyze, repetition_vector,
        Simulator, Mapping, PlatformGraph, PlatformModel,
        synthesize, StagedProgram, Explorer,
    )
"""
from repro_torch.core.graph import (Actor, ActorType, Dpg, Fifo, Graph, Port,
                                    PortDir, fifo, parent)
from repro_torch.core.analyzer import (AnalysisReport, analyze,
                                       repetition_vector)
from repro_torch.core.simulator import SimResult, Simulator
from repro_torch.core.mapping import (Link, Mapping, PlatformGraph,
                                      PlatformModel, ProcessingUnit,
                                      paper_platform, tpu_pod_platform)
from repro_torch.core.synthesis import (Channel, PipelineSchedule, Stage,
                                        StagedProgram, StageExec, StageFn,
                                        compile_local_step, read_mapping_file,
                                        synthesize, write_mapping_file)
from repro_torch.core.explorer import (ExplorationResult, Explorer,
                                       PartitionRecord)

__all__ = [
    "Actor", "ActorType", "Dpg", "Fifo", "Graph", "Port", "PortDir",
    "fifo", "parent",
    "AnalysisReport", "analyze", "repetition_vector",
    "SimResult", "Simulator",
    "Link", "Mapping", "PlatformGraph", "PlatformModel", "ProcessingUnit",
    "paper_platform", "tpu_pod_platform",
    "Channel", "PipelineSchedule", "Stage", "StagedProgram", "StageExec",
    "StageFn", "compile_local_step",
    "read_mapping_file", "synthesize", "write_mapping_file",
    "ExplorationResult", "Explorer", "PartitionRecord",
]
