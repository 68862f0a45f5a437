from repro_torch.sharding.rules import (batch_shardings, cache_shardings,
                                        compute_params_shardings,
                                        device_bytes, params_shardings,
                                        replicated, spec_for)

__all__ = ["batch_shardings", "cache_shardings", "compute_params_shardings",
           "device_bytes", "params_shardings", "replicated", "spec_for"]
