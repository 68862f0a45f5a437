from repro_torch.sharding.rules import (NoopShardCtx, ShardCtx,
                                        batch_shardings, cache_shardings,
                                        cache_spec, combine_partials,
                                        compute_params_shardings,
                                        device_bytes, gather_cache,
                                        gather_params, params_shardings,
                                        replicated, shard_batch, shard_cache,
                                        shard_params, spec_for)

__all__ = ["NoopShardCtx", "ShardCtx", "batch_shardings", "cache_shardings",
           "cache_spec", "combine_partials", "compute_params_shardings",
           "device_bytes", "gather_cache", "gather_params",
           "params_shardings", "replicated", "shard_batch", "shard_cache",
           "shard_params", "spec_for"]
