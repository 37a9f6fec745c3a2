"""The performance model (``repro/perfmodel``), over a device profile.

Every decision the planner makes (layout, storage dtype, stack pairing)
is priced by one analytic traffic model: predicted device-memory bytes and
roofline seconds per (fused op, layout, dtype).

  * ``hardware``    -- the ``Hardware`` profile that holds every device
                       input of the model; ``default_hardware()`` is the
                       H100's, ``hardware_id()`` names the silicon;
  * ``traffic``     -- the analytic byte/seconds models (conv chains,
                       stacks, backward, cast edges);
  * ``calibration`` -- the paper's (Ct, Nt) thresholds, the Fig. 4 sweep
                       (over the model, or timing K1/K2 on the card),
                       threshold rows versioned by hardware id, and the
                       predicted-vs-measured cross-validation;
  * ``model``       -- the ``CostModel`` interface the planner consumes
                       (``AnalyticCostModel``, ``CalibratedCostModel``).
"""
from repro_torch.perfmodel.hardware import (  # noqa: F401
    Hardware, default_hardware, hardware_id)
from repro_torch.perfmodel.traffic import (  # noqa: F401
    DEFAULT_DTYPE_BYTES, STACK_NT_CANDIDATES, ConvCost, cast_bytes,
    cast_cost, chain_bytes, chain_fits, conv_backward_bytes,
    conv_backward_cost, conv_cost, conv_flops, dgrad_bytes, dilated_hw,
    fused_chain_cost, fusion_saved_bytes, select_conv_layout_cost,
    stack_blocking, stack_bytes, stack_fused_cost, stack_nt,
    stack_vmem_bytes, tile_utilization, train_chain_bytes, wgrad_bytes)
from repro_torch.perfmodel.calibration import (  # noqa: F401
    DEFAULT_HARDWARE, CalibrationPoint, CrossValidation, Thresholds,
    calibrate, card_conv_measure, cross_validate, load_thresholds,
    measured_thresholds, proxied_layer, save_thresholds,
    select_conv_layout, select_pool_layout)
from repro_torch.perfmodel.model import (  # noqa: F401
    AnalyticCostModel, CalibratedCostModel, CostModel, default_cost_model)
