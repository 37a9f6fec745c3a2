"""The performance model (``repro/perfmodel``).

Ported so far: the paper's two-threshold layout rule (``calibration``:
``Thresholds``, ``select_conv_layout``, ``select_pool_layout``) and the
backward-pass byte entries of the traffic model (``traffic``:
``dilated_hw``, ``dgrad_bytes``, ``wgrad_bytes``, ``conv_backward_bytes``),
which price ``RunStats.bwd_hbm_bytes``.  The reference's forward traffic
and roofline model, its ``CostModel`` and its threshold sweep
(``calibrate``, which times a model of the TPU) are not: the port's
unfused "opt" plans come from the packaged plan files, and its heuristic
plans take explicit thresholds.
"""
from repro_torch.perfmodel.calibration import (  # noqa: F401
    Thresholds, select_conv_layout, select_pool_layout)
from repro_torch.perfmodel.traffic import (  # noqa: F401
    conv_backward_bytes, dgrad_bytes, dilated_hw, wgrad_bytes)
