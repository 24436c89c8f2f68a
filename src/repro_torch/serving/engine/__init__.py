from repro_torch.kernels.quantize import KVQuantConfig
from repro_torch.serving.engine.engine import Engine, EngineConfig
from repro_torch.serving.engine.oversub import OversubConfig, SLOPolicy
from repro_torch.serving.engine.paged_cache import (BlockPool, BlockPoolError,
                                                    prefix_hashes)
from repro_torch.serving.engine.scheduler import Request, Scheduler
from repro_torch.serving.engine.spec import (Drafter, DraftModelDrafter,
                                             NgramDrafter, ReplayDrafter,
                                             SpecConfig)
from repro_torch.serving.telemetry import (MetricsRegistry, RecompileTracker,
                                           RequestTracer, Telemetry)

__all__ = ["Engine", "EngineConfig", "KVQuantConfig", "BlockPool", "BlockPoolError",
           "Request", "Scheduler", "prefix_hashes", "MetricsRegistry",
           "RecompileTracker", "RequestTracer", "Telemetry", "Drafter",
           "DraftModelDrafter", "NgramDrafter", "ReplayDrafter", "SpecConfig",
           "OversubConfig",
           "SLOPolicy"]
