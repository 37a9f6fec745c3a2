from repro_torch.core.layout import (perm_between, plan_transform,  # noqa: F401
                                     transform_bytes)
from repro_torch.core.selector import (Assignment, FusedOp,  # noqa: F401
                                       FusedPlan, LayerDesc,
                                       paper_heuristic_layouts)
from repro_torch.core.transform import apply_transform  # noqa: F401
