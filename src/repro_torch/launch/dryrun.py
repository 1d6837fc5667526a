# Dry run (port of ``repro/launch/dryrun.py``): trace every (architecture
# × input-shape × mesh) step at the config's full size, without a card and
# without allocating it, and record the roofline inputs (FLOPs, bytes,
# collective traffic, memory).
#
# The reference lowers and compiles each step for its production mesh.
# The port's program is the aten ops a step dispatches: the step runs
# once on fake tensors (``torch._subclasses.FakeTensorMode``) under the op
# counter of ``launch/hlo_analysis.py``.  ``--device cuda`` (the default)
# traces the card's program: the hand-written kernels are recorded in
# place of their launches, with their bytes and FLOPs from
# ``kernels/cost.py``; ``--device cpu`` traces the plain versions.  The
# ``hlo_*`` and ``mem_*`` counts are the whole step on one card.  The mesh
# (``launch/mesh.py``) gives the chip count and, through
# ``dist/partition.py``'s specs, the argument bytes a chip of it would
# hold.  The reference reads its per-device fields from the SPMD program
# compiled for the mesh; here the process joins a ``fake`` process group
# of the mesh's size as rank 0, builds the sharded step on a DeviceMesh
# and traces that rank's program on fake shards: ``per_device_*`` and
# ``cross_pod_bytes`` are rank 0's (``per_device_scope``), the collectives'
# bytes those it would move (the fake group moves none).
#
# Usage:
#   PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \
#       --shape all --mesh single --out artifacts/dryrun
#   PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b \
#       --shape train_4k --mesh single --save-hlo artifacts/hlo

import argparse
import contextlib
import json
import os
import time
import traceback

import torch

from repro_torch.configs import (ARCHS, INPUT_SHAPES, get_config,
                                 long_context_window, shape_skips)
from repro_torch.configs.base import TrainConfig
from repro_torch.dist import partition
from repro_torch.launch import hlo_analysis
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.utils import tree_leaves

# the fields a rank's program on the production mesh gives
SPMD_ONLY = ("per_device_dot_flops", "per_device_collective_bytes",
             "per_device_temp_bytes")


@contextlib.contextmanager
def fake_world(n: int):
    """This process as rank 0 of a ``fake`` process group of ``n`` ranks
    for the body (one process group at a time: an initialized one is
    refused), destroyed after."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a rank trace needs its own process group; one "
                           "is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def rank_trace(mode: str, build, mesh, device: str = "cuda") -> dict:
    """Rank 0's program of a sharded step on ``mesh``: the process joins
    a fake group of ``mesh.size`` ranks, ``build(dmesh)`` makes the step
    on its DeviceMesh and the rank's shards are traced
    (``hlo_analysis.trace``)."""
    from repro_torch.launch.steps import place_abstract
    dev, _ = hlo_analysis.fake_device(device)
    with fake_world(mesh.size):
        dmesh = mesh_lib.device_mesh(mesh, dev)
        fn, args = build(dmesh)
        return hlo_analysis.trace(
            fn, args, device,
            place=lambda a, d: place_abstract(mode, fn, a, dmesh, d),
            dmesh=dmesh)


def sharded_bytes(tree, specs, mesh) -> int:
    """Bytes of ``tree`` that one chip of ``mesh`` holds under ``specs``
    (one spec a leaf, in the tree's order)."""
    sizes = mesh.shape
    leaves = [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]
    spec_leaves = tree_leaves(specs, is_leaf=partition.is_spec)
    if len(leaves) != len(spec_leaves):
        raise ValueError(f"{len(leaves)} leaves but {len(spec_leaves)} "
                         "specs")
    total = 0
    for x, spec in zip(leaves, spec_leaves):
        n = 1
        for entry in spec:
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                n *= sizes.get(ax, 1) if ax else 1
        total += x.numel() * x.element_size() // n
    return total


def _per_device_args(mode: str, fn, args, mesh) -> int:
    sp = fn.specs
    if mode == "train":
        params, opt, batch = args
        return (sharded_bytes(params, sp["params"], mesh)
                + sharded_bytes(opt.mu, sp["params"], mesh)
                + sharded_bytes(opt.nu, sp["params"], mesh)
                + opt.step.element_size()
                + sharded_bytes(batch, sp["batch"], mesh))
    if mode == "prefill":
        params, batch = args
        return (sharded_bytes(params, sp["params"], mesh)
                + sharded_bytes(batch, sp["batch"], mesh))
    params, cache, token, pos = args
    return (sharded_bytes(params, sp["params"], mesh)
            + sharded_bytes(cache, sp["cache"], mesh)
            + sharded_bytes({"token": token, "pos": pos}, sp["batch"], mesh))


def run_one(arch: str, shape_name: str, multi_pod: bool, lgr: str = "har",
            act_sharding: str = "dmodel", save_hlo: str = "",
            cache_layout: str = "heads", serve_fsdp: bool = False,
            cfg_overrides: dict = None, moe_spec: str = "contract",
            decode_unroll: bool = False, microbatches: int = 1,
            per_layer_cache: bool = False, device: str = "cuda") -> dict:
    """One dry-run record.  ``act_sharding`` and ``decode_unroll`` are
    recorded but change nothing on one card (``configs/presets.py``);
    ``save_hlo`` is a path for the gzipped trace."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    shape = INPUT_SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "lgr": lgr, "act_sharding": act_sharding,
           "cache_layout": cache_layout, "moe_spec": moe_spec,
           "device": device, "status": "skip"}
    if cfg_overrides:
        rec["cfg_overrides"] = cfg_overrides
    skips = shape_skips(arch)
    if shape_name in skips:
        rec["reason"] = skips[shape_name]
        return rec
    window = long_context_window(arch) if shape_name == "long_500k" else None
    if window:
        rec["window_override"] = window

    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)

    def build(m):
        if shape.mode == "train":
            return make_train_step(cfg, m, shape,
                                   TrainConfig(microbatches=microbatches),
                                   lgr=lgr, moe_spec=moe_spec,
                                   act_sharding=act_sharding)
        if shape.mode == "prefill":
            return make_prefill_step(cfg, m, shape, window,
                                     act_sharding=act_sharding)
        return make_serve_step(cfg, m, shape, window,
                               cache_layout=cache_layout,
                               params_fsdp=serve_fsdp,
                               per_layer_cache=per_layer_cache)
    fn, args = build(mesh)
    res = hlo_analysis.trace(fn, args, device)
    hl = res["counts"]
    if save_hlo:
        hlo_analysis.save_trace(res["trace"], save_hlo)
    del res["trace"]      # counted: not held through the rank's trace
    rec.update({
        "status": "ok",
        "lower_s": round(res["seconds"], 1),
        "compile_s": None,
        "chips": mesh.size,
        "scope": "whole step on one card",
        "hlo_flops_costan": float(res["flop_counter"]),
        "hlo_dot_flops": hl["dot_flops"],
        "hlo_plain_fwd_dot_flops": hl["plain_fwd_dot_flops"],
        "hlo_traffic_bytes": hl["traffic_bytes"],
        "collective_bytes": hl["collective_bytes"],
        "cross_pod_bytes": hl["cross_pod_bytes"],
        "coll_by_op": hl["coll_by_op"],
        "coll_counts": hl["coll_counts"],
        "kernel_flops": hl["kernel_flops"],
        "kernel_bytes": hl["kernel_bytes"],
        "kernel_calls": hl["kernel_calls"],
        "mem_argument_bytes": hl["mem_argument_bytes"],
        "mem_output_bytes": hl["mem_output_bytes"],
        "mem_temp_bytes": hl["mem_temp_bytes"],
        "mem_alias_bytes": hl["mem_alias_bytes"],
        "mem_argument_bytes_per_device": _per_device_args(
            shape.mode, fn, args, mesh),
    })
    # live bytes: the arguments + the peak above them (outputs included)
    rec["mem_per_device_bytes"] = (hl["mem_argument_bytes"]
                                   + hl["mem_temp_bytes"])
    rk = rank_trace(shape.mode, build, mesh, device)
    pd = rk["counts"]
    if save_hlo:
        hlo_analysis.save_trace(rk["trace"],
                                save_hlo.replace(".hlo.gz", "_rank0.hlo.gz"))
    rec.update({
        "per_device_scope": "rank 0 of the mesh",
        "per_device_trace_s": round(rk["seconds"], 1),
        "per_device_dot_flops": pd["dot_flops"],
        "per_device_plain_fwd_dot_flops": pd["plain_fwd_dot_flops"],
        "per_device_collective_bytes": pd["collective_bytes"],
        "per_device_temp_bytes": pd["mem_temp_bytes"],
        "per_device_argument_bytes": pd["mem_argument_bytes"],
        "per_device_coll_by_op": pd["coll_by_op"],
        "per_device_coll_counts": pd["coll_counts"],
        "per_device_kernel_calls": pd["kernel_calls"],
        "per_device_kernel_flops": pd["kernel_flops"],
        "cross_pod_bytes": pd["cross_pod_bytes"],
    })
    rec["per_device_mem_bytes"] = (pd["mem_argument_bytes"]
                                   + pd["mem_temp_bytes"])
    rec["dot_redundancy"] = hlo_analysis.dot_redundancy(hl, pd, mesh.size)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--lgr", default="har", choices=["har", "mrr"])
    ap.add_argument("--act-sharding", default="dmodel",
                    choices=["dmodel", "seq", "none"])
    ap.add_argument("--cache-layout", default="heads",
                    choices=["heads", "seq"])
    ap.add_argument("--serve-fsdp", action="store_true")
    ap.add_argument("--moe-spec", default="contract",
                    choices=["contract", "expert", "tp_both"])
    ap.add_argument("--decode-unroll", action="store_true")
    ap.add_argument("--per-layer-cache", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--cfg-override", default="",
                    help="JSON dict of ModelConfig overrides (perf exps)")
    ap.add_argument("--preset", action="store_true",
                    help="use the best-known knobs per (arch x shape)")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--save-hlo", default="",
                    help="directory for each cell's gzipped trace, "
                         "ARCH_SHAPE_MESH.hlo.gz (launch/reanalyze.py)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the card's program, kernels recorded; "
                         "cpu: the plain versions")
    args = ap.parse_args(argv)
    overrides = json.loads(args.cfg_override) if args.cfg_override else None

    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = list(INPUT_SHAPES) if args.shape == "all" \
        else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    if args.save_hlo:
        os.makedirs(args.save_hlo, exist_ok=True)
    ok = failed = skipped = 0
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                mesh_tag = "multi" if multi else "single"
                tag = f"{arch}_{shape}_{mesh_tag}_{args.lgr}_" \
                      f"{args.act_sharding}"
                if args.preset:
                    tag = f"{arch}_{shape}_{mesh_tag}_preset"
                if args.cache_layout != "heads":
                    tag += f"_cache{args.cache_layout}"
                if args.serve_fsdp:
                    tag += "_sfsdp"
                if args.moe_spec != "contract":
                    tag += f"_moe{args.moe_spec}"
                if args.decode_unroll:
                    tag += "_unroll"
                if args.per_layer_cache:
                    tag += "_plc"
                if args.microbatches > 1:
                    tag += f"_mb{args.microbatches}"
                if overrides:
                    tag += "_ovr" + "".join(sorted(overrides))[:24]
                if args.device != "cuda":
                    tag += f"_{args.device}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"[cached] {tag}")
                    ok += 1
                    continue
                save = os.path.join(
                    args.save_hlo, f"{arch}_{shape}_{mesh_tag}.hlo.gz") \
                    if args.save_hlo else ""
                try:
                    if args.preset:
                        from repro_torch.configs.presets import preset
                        kw = preset(arch, shape)
                        rec = run_one(arch, shape, multi,
                                      kw["lgr"], kw["act_sharding"],
                                      save, kw["cache_layout"],
                                      False, overrides, kw["moe_spec"],
                                      kw["decode_unroll"],
                                      kw["microbatches"],
                                      kw.get("per_layer_cache", False),
                                      device=args.device)
                        rec["preset"] = True
                    else:
                        rec = run_one(arch, shape, multi, args.lgr,
                                      args.act_sharding, save,
                                      args.cache_layout, args.serve_fsdp,
                                      overrides, args.moe_spec,
                                      args.decode_unroll, args.microbatches,
                                      args.per_layer_cache,
                                      device=args.device)
                except Exception as e:
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if multi else "16x16",
                           "status": "error", "error": repr(e),
                           "traceback": traceback.format_exc()[-2000:]}
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                if rec["status"] == "ok":
                    ok += 1
                    print(f"[ok] {tag}: trace={rec['lower_s']}s "
                          f"mem/step={rec['mem_per_device_bytes']/2**30:.2f}"
                          f"GiB dotTF={rec['hlo_dot_flops']/1e12:.2f} "
                          f"kernelTF="
                          f"{sum(rec['kernel_flops'].values())/1e12:.2f} "
                          f"collGB={rec['collective_bytes']/2**30:.3f} "
                          f"| rank0 mem="
                          f"{rec['per_device_mem_bytes']/2**30:.2f}GiB "
                          f"dotTF={rec['per_device_dot_flops']/1e12:.3f} "
                          f"collGB="
                          f"{rec['per_device_collective_bytes']/2**30:.3f} "
                          f"podGB={rec['cross_pod_bytes']/2**30:.3f} "
                          f"x{rec['dot_redundancy'] or 0:.3f} "
                          f"trace={rec['per_device_trace_s']}s")
                elif rec["status"] == "skip":
                    skipped += 1
                    print(f"[skip] {tag}: {rec['reason']}")
                else:
                    failed += 1
                    print(f"[FAIL] {tag}: {rec['error']}")
    print(f"\ndry-run summary: ok={ok} skipped={skipped} failed={failed}")
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
