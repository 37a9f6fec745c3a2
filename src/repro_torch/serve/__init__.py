from repro_torch.serve.plan_cache import (PlanCache, PlanKey,  # noqa: F401
                                          PlanMissError, bucket_for,
                                          network_id, pad_to_bucket)
