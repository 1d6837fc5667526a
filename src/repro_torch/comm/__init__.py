"""repro_torch.comm — the unified communication subsystem (paper §4.1),
port of ``repro/comm``.

Public surface:

* schedules — N-level LGR reduction schedules over 2-axis (gpu, inst) and
  3-axis (gpu, inst, dev) instance grids, in two forms: grid-stacked
  tensors in one process (``lgr_allreduce``, what GMIs sharing one card
  run) and ``torch.distributed`` collectives over per-axis subgroups, one
  rank per instance (``make_grad_sync``, ``flat_psum``,
  ``hierarchical_psum``, ``axis_groups``); plus the host-staged
  ``mpr_host``;
* select — Algorithm-1 shape selection with an optional Table-2
  ``ReduceCostModel`` layered on top (``select_reduction_strategy``);
* api — the :class:`Communicator` object every training layer consumes
  instead of string-passing strategy names;
* calibrate — the :class:`BandwidthCalibrator` that inverts the Table-2
  recurrences over measured reduce and transfer times.  On one card only
  the instance-level term (B1) can be measured; B2 and B3 keep the cost
  model's constants.
"""
from repro_torch.comm.api import Communicator, as_grad_sync  # noqa: F401
from repro_torch.comm.calibrate import (BandwidthCalibrator,  # noqa: F401
                                        FitResult)
from repro_torch.comm.schedules import (STRATEGIES,  # noqa: F401
                                        axis_groups, flat_psum,
                                        hierarchical_psum, lgr_allreduce,
                                        make_grad_sync, mpr_host)
from repro_torch.comm.select import (ReduceCostModel,  # noqa: F401
                                     algorithm1, select_reduction_strategy)
