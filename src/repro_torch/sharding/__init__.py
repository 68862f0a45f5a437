from repro_torch.sharding.rules import (NoopShardCtx, ShardCtx,
                                        batch_shardings, cache_shardings,
                                        compute_params_shardings,
                                        device_bytes, gather_params,
                                        params_shardings, replicated,
                                        shard_batch, shard_params, spec_for)

__all__ = ["NoopShardCtx", "ShardCtx", "batch_shardings", "cache_shardings",
           "compute_params_shardings", "device_bytes", "gather_params",
           "params_shardings", "replicated", "shard_batch", "shard_params",
           "spec_for"]
