"""The performance model (``repro/perfmodel``).

Only the paper's two-threshold layout rule is ported so far
(``calibration``): ``Thresholds``, ``select_conv_layout`` and
``select_pool_layout``.  The reference's analytic traffic model, its
``CostModel`` and its threshold sweep (``calibrate``, which times a model of
the TPU) are not: the port's unfused "opt" plans come from the packaged
plan files, and its heuristic plans take explicit thresholds.
"""
from repro_torch.perfmodel.calibration import (  # noqa: F401
    Thresholds, select_conv_layout, select_pool_layout)
