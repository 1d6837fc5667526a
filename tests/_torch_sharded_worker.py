"""One rank of the port's sharded LM steps on gloo (CPU), spawned by
tests/test_torch_sharded.py: four ranks on a (data 2, model 2) mesh.
Imports torch and the port only.  Every result is gathered to full
tensors and rank 0 saves them; the test compares them with the unsharded
step and the JAX package."""
import numpy as np
import torch
import torch.distributed as dist

MESH = ((2, 2), ("data", "model"))


def _flat(prefix, tree, out):
    from repro_torch.checkpoint.ckpt import keystr_leaves
    from repro_torch.dist.partition import gather_tree
    for k, v in keystr_leaves(gather_tree(tree)):
        out[prefix + k] = v.detach().numpy()


def _train(cfg, params, batch, dm, res, tag, **kw):
    from repro_torch.configs.base import InputShape, TrainConfig
    from repro_torch.dist import partition
    from repro_torch.launch import steps as TS
    from repro_torch.optim import adam_init
    B, S = batch["tokens"].shape
    fn, _ = TS.make_train_step(cfg, dm, InputShape("t", S, B, "train"),
                               TrainConfig(grad_clip=kw.pop("clip", 1.0)),
                               **kw)
    p, o = TS.place_train_state(params, adam_init(params),
                                fn.specs["params"], dm)
    b = partition.distribute_tree(batch, fn.specs["batch"], dm)
    p2, o2, m = fn(p, o, b)
    res[f"{tag}/loss"] = m["loss"].full_tensor().numpy()
    res[f"{tag}/placed"] = np.asarray([
        all(tuple(x.placements) == tuple(y.placements) for x, y in
            zip(partition.tree_leaves(p2), partition.tree_leaves(p)))])
    _flat(f"{tag}/params", p2, res)
    _flat(f"{tag}/mu", o2.mu, res)
    _flat(f"{tag}/nu", o2.nu, res)


def _placed(caches, specs, dm):
    """Whether every cache leaf is placed as ``specs`` place it, its local
    tensor the shard those placements cut, one entry a leaf."""
    from repro_torch.dist import partition, spmd
    pls = partition.tree_leaves(partition.to_placements(specs, dm),
                                is_leaf=lambda t: isinstance(t, tuple) and all(
                                    not isinstance(e, (str, tuple,
                                                       type(None)))
                                    for e in t))
    out = []
    for x, pl in zip(partition.tree_leaves(caches), pls):
        cut = [s.stop - s.start for s in spmd.local_slices(x.shape, pl, dm)]
        out.append(tuple(x.placements) == tuple(pl)
                   and list(x.to_local().shape) == cut)
    return np.asarray(out)


def _serve(cfg, params, batch, dm, res):
    """Prefill then one decode step on the prefilled caches: logits, the
    caches after each, and whether they kept their placements."""
    from repro_torch.configs.base import InputShape
    from repro_torch.dist import partition
    from repro_torch.launch import steps as TS
    B, S = batch["tokens"].shape
    fn, _ = TS.make_prefill_step(cfg, dm, InputShape("p", S, B, "prefill"))
    pp = partition.distribute_tree(params, fn.specs["params"], dm)
    logits, caches = fn(pp, partition.distribute_tree(
        batch, fn.specs["batch"], dm))
    res["prefill/logits"] = logits.full_tensor().numpy()
    _flat("prefill/cache", caches, res)
    sfn, _ = TS.make_serve_step(cfg, dm, InputShape("d", S, B, "decode"))
    res["prefill/placed"] = _placed(caches, sfn.specs["cache"], dm)
    tok = torch.argmax(logits.full_tensor(), -1).to(torch.int32)
    pos = torch.full((B,), S, dtype=torch.int32)
    tp = partition.distribute_tree({"token": tok, "pos": pos},
                                   sfn.specs["batch"], dm)
    lg, caches = sfn(pp, caches, tp["token"], tp["pos"])
    res["serve/logits"] = lg.full_tensor().numpy()
    res["serve/token"] = torch.argmax(lg.full_tensor(), -1).numpy()
    res["serve/placed"] = _placed(caches, sfn.specs["cache"], dm)
    _flat("serve/cache", caches, res)


def _checkpoint(params, dm, res, path):
    """A DTensor tree saved whole, then restored onto its placements."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.dist import partition
    from repro_torch.launch.mesh import logical
    specs = partition.param_specs(params, logical(dm), fsdp=True)
    placed = partition.distribute_tree(params, specs, dm)
    ckpt.save(path, placed, step=1)
    dist.barrier()
    pl = partition.to_placements(specs, dm)
    back = ckpt.load(path, params, device="cpu", placements=pl, mesh=dm)
    same = [bool(torch.equal(a.to_local(), b.to_local()))
            and tuple(a.placements) == tuple(b.placements)
            for a, b in zip(partition.tree_leaves(placed),
                            partition.tree_leaves(back))]
    res["ckpt/same"] = np.asarray(same)
    _flat("ckpt/full", back, res)


def _clip(params, dm, res):
    """One Adam update with a clip that binds: its global norm and the
    updated params."""
    from repro_torch.dist import partition
    from repro_torch.launch.mesh import logical
    from repro_torch.optim import adam_init, adam_update
    from repro_torch.utils import global_norm, tree_map
    specs = partition.param_specs(params, logical(dm), fsdp=True)
    grads = tree_map(lambda x: torch.cos(x * 3.0), params)
    g = partition.distribute_tree(grads, specs, dm)
    p = partition.distribute_tree(params, specs, dm)
    o = adam_init(p)
    res["clip/norm"] = global_norm(g).full_tensor().numpy()
    p2, _ = adam_update(g, o, p, lr=1e-2, grad_clip=0.5)
    _flat("clip/params", p2, res)


def run(rank, world, port, payload, out_path, ckpt_path):
    from repro_torch.launch.mesh import device_mesh, make_mesh
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        dm = device_mesh(make_mesh(*MESH), "cpu")
        res = {}
        for arch, params, batch, cases in payload:
            cfg = reduced(arch)
            params = {k: v for k, v in _tensors(params).items()}
            batch = _tensors(batch)
            for case in cases:
                if case.startswith("train"):
                    _, lgr, moe_spec = case.split("/")
                    _train(cfg, params, batch, dm, res, f"{arch}/{case}",
                           lgr=lgr, moe_spec=moe_spec)
                elif case == "serve":
                    sub = {}
                    _serve(cfg, params, {"tokens": batch["tokens"],
                                         "labels": batch["labels"]}, dm, sub)
                    res.update({f"{arch}/{k}": v for k, v in sub.items()})
                elif case == "ckpt":
                    _checkpoint(params, dm, res, ckpt_path)
                elif case == "clip":
                    _clip(params, dm, res)
        if rank == 0:
            np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


def reduced(name):
    """The reduced config of ``name``: an arch, or ``ARCH/h1`` for that
    arch with one head (xlstm-1.3b's recurrent heads then divide no
    ``model`` split, as its 4 heads do not divide 16 at full width)."""
    from repro_torch.configs import get_reduced
    arch, _, tag = name.partition("/")
    cfg = get_reduced(arch)
    return cfg.replace(num_heads=1, num_kv_heads=1) if tag == "h1" else cfg


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.as_tensor(tree)
