# The paper's primary contribution: GPU spatial multiplexing for DRL.
# channels.py — channel-based experience sharing MCC (§4.2), device-resident
#               rings packed by the pack_channels kernel
# The GMI abstraction, placement, selection and the online controller
# (repro/core/gmi.py, placement.py, selection.py, controller.py,
# cost_model.py) are not ported yet.
from repro_torch.core import channels  # noqa: F401
