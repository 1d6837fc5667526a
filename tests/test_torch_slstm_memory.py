"""The sLSTM's recurrent weight ``r`` in a training step's memory: the
port's reduced xlstm-1.3b train step in bf16 (params in the compute
dtype, as the dry run holds them), traced on fake tensors by
``launch/hlo_analysis.trace``.

``slstm_apply`` reads ``r`` in f32.  Cast inside the time loop, every
step would make its own f32 copy, and autograd would keep each one for
the einsum's backward: S copies a block, live at the step's peak as the
backward recomputes the block.  Cast once before the loop, a block holds
one, whatever S is."""
import pytest

from repro_torch.configs import InputShape, get_reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import hlo_analysis
from repro_torch.launch.steps import make_train_step

ARCH = "xlstm-1.3b"


def _cfg():
    return get_reduced(ARCH).replace(dtype="bfloat16")


def _r_spec(cfg):
    dh = cfg.d_model // cfg.num_heads
    return f"f32[{cfg.num_heads},{dh},{4 * dh}]"


def _r_copies(S):
    """(f32 buffers of ``r``'s shape live at the peak, the most f32 casts
    of ``r`` live at once anywhere in the step) for a batch of 2 x
    ``S``.  The second leaves out the gradient's f32 sums, which have
    ``r``'s shape too."""
    cfg = _cfg()
    fn, args = make_train_step(cfg, None, InputShape("t", S, 2, "train"),
                               TrainConfig())
    trace = hlo_analysis.trace(fn, args, "cuda")["trace"]
    r = _r_spec(cfg)
    nbytes = hlo_analysis._nbytes(r)
    _, held = hlo_analysis.live_at_peak(trace)
    at_peak = sum(b for b, _, outs in held if outs == (r,)) // nbytes
    sizes, live, most = {}, 0, 0
    for ev in trace["events"]:
        if ev[0] != "op":
            continue
        for tid in ev[5]:
            live -= sizes.pop(tid, 0)
        if ev[1] == "aten._to_copy" and ev[3] == [r]:
            for tid, _ in ev[4]:
                sizes[tid] = 1
                live += 1
        most = max(most, live)
    return at_peak, most


def _slstm_blocks(cfg):
    return cfg.num_super * sum(k == "slstm" for k in cfg.block_pattern)


@pytest.fixture(scope="module")
def copies():
    return {S: _r_copies(S) for S in (32, 64)}


@pytest.mark.parametrize("S", [32, 64])
def test_slstm_recurrent_weight_held_once_a_block(copies, S):
    """At the step's peak, and anywhere in it, at most one f32 copy of
    ``r`` a sLSTM block is live."""
    blocks = _slstm_blocks(_cfg())
    assert blocks >= 1
    at_peak, most = copies[S]
    assert at_peak <= blocks, (S, at_peak, blocks)
    assert most <= blocks, (S, most, blocks)


def test_slstm_recurrent_copies_do_not_grow_with_seq(copies):
    """The count does not grow from S = 32 to S = 64."""
    assert copies[64][0] <= copies[32][0], copies
    assert copies[64][1] <= copies[32][1], copies
