"""One rank of the port's collective LGR schedules on gloo (CPU), spawned
by tests/test_torch_comm.py.  Imports torch and the port only."""
import numpy as np
import torch
import torch.distributed as dist


def run(rank, world, port, shape, axes, grads, strategies, out_path):
    """Reduce this rank's gradient tree (``grads[rank]``, numpy) with
    every strategy in ``strategies``, averaged and summed, and save the
    results to ``out_path``."""
    from repro_torch.comm import axis_groups, make_grad_sync
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        groups = axis_groups(shape, axes)
        mine = {k: torch.as_tensor(v) for k, v in grads[rank].items()}
        res = {}
        for strat in strategies:
            for average in (True, False):
                sync = make_grad_sync(strat, axes, average=average,
                                      groups=groups)
                for k, v in sync(mine).items():
                    res[f"{strat}/{average}/{k}"] = v.numpy()
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()
