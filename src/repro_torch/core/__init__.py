# The paper's primary contribution: GPU spatial multiplexing for DRL.
# gmi.py        — instance abstraction + manager (paper §3); each GMI of
#                 one process runs on its share of the card's SMs (a
#                 green context and its stream)
# sm_partition.py — the CUDA driver calls that carve those shares
#                 (csrc/sm_partition.cu)
# placement.py  — task-aware GMI mapping templates (§5.1); Algorithm 1
#                 lives in repro_torch.comm.select and is re-exported here
# channels.py   — channel-based experience sharing MCC (§4.2), device-
#                 resident rings packed by the pack_channels kernel
# selection.py  — workload-aware GMI selection, Algorithm 2 (§5.2)
# controller.py — online GMI management: Algorithm 2 at run time over
#                 measured rounds and serving loads
# cost_model.py — analytical models, Tables 2/4/5 (+3-level HAR), Eqs. 1-3
from repro_torch.core import (channels, controller,  # noqa: F401
                              cost_model, gmi, placement, selection)
from repro_torch.core.controller import (ControllerConfig,  # noqa: F401
                                         OnlineGMIController)
from repro_torch.core.gmi import DRLRole, GMI, GMIManager  # noqa: F401
from repro_torch.core.placement import select_reduction_strategy  # noqa: F401
