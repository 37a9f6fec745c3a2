from repro_torch.serve.plan_cache import (CacheStats, PlanCache,  # noqa: F401
                                          PlanKey, bucket_for, network_id,
                                          pad_to_bucket)
