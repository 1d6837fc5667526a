from repro_torch.fault.inject import (KINDS, TEAR_MODES,  # noqa: F401
                                      FaultEvent, FaultPlan, InjectedFault,
                                      make_save_crash_hook, poison_channels,
                                      tear_checkpoint)
from repro_torch.fault.supervisor import FleetSupervisor  # noqa: F401
