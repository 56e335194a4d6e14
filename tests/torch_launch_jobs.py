"""What each rank of a spawned world runs for ``tests/test_torch_launch*.py``
(imports no JAX: the children import only this module, torch and the
port).  Inputs arrive as numpy arrays and trees, results leave as numpy.
``suite(rank, tasks)`` runs a list of ``(key, job name, kwargs)`` in one
world and returns ``{key: result}``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

_MESHES = {}


def mesh(shape):
    """One DeviceMesh per shape for the process's life (its subgroups are
    made once, by every rank)."""
    from repro_torch.launch.mesh import make_mesh
    shape = tuple(shape)
    if shape not in _MESHES:
        _MESHES[shape] = make_mesh(shape, device_type="cpu")
    return _MESHES[shape]


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_t(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def _np_flat(tree):
    from repro_torch.core.tree import leaves_with_paths
    from repro_torch.launch.sharding import is_dtensor
    return {k: (v.full_tensor() if is_dtensor(v) else v).detach().numpy()
            for k, v in leaves_with_paths(tree)}


def suite(rank, tasks):
    return {key: globals()[job](rank, **kw) for key, job, kw in tasks}


# ------------------------------------------------------------------ jobs --

def moe_ep(rank, x, p, top_k, capacity_factor):
    """``moe_mlp_ep`` on this rank's tokens ``x[rank]`` and experts."""
    from repro_torch.launch.collectives import Collectives
    from repro_torch.models.moe import moe_mlp_ep
    n = x.shape[0]  # the ranks' token blocks
    m = mesh((1, n))
    e_loc = p["wg"].shape[0] // n
    local = {k: torch.from_numpy(np.array(
        v[rank * e_loc:(rank + 1) * e_loc] if k in ("wg", "wu", "wd") else v))
        for k, v in p.items()}
    coll = Collectives(m)
    with torch.no_grad():
        y = moe_mlp_ep(torch.from_numpy(x[rank]), local, top_k=top_k,
                       group=coll.on("model"),
                       capacity_factor=capacity_factor)
    return y.numpy()


def _cfg(arch, over):
    from repro_torch.configs.lm_archs import ARCHS
    return dataclasses.replace(ARCHS[arch].smoke(), **over)


class _Log:
    """While entered: each collective ``par`` issues as ``(kind, shape)``
    and the residual stream's shape entering each block."""

    def __init__(self, par):
        self.par, self.collectives, self.stream = par, [], []

    def __enter__(self):
        from repro_torch.models import stack
        coll, count, block = self.par.coll, self.par.coll._count, \
            stack.apply_block

        def counted(kind, x):
            self.collectives.append((kind, tuple(x.shape)))
            count(kind, x)

        def logged(x, *args, **kw):
            self.stream.append(tuple(x.shape))
            return block(x, *args, **kw)
        coll._count, stack.apply_block = counted, logged
        self._restore = lambda: (setattr(stack, "apply_block", block),
                                 delattr(coll, "_count"))
        return self

    def __exit__(self, *exc):
        self._restore()


def variant(rank, arch, over, shape, moe, ulysses, params, batch,
            attn_rule="auto"):
    """The meshed forward's whole logits, the unmeshed forward's, the
    collectives the meshed one issued (all, and those past the
    parameters' gathers as ``(kind, shape)``), the residual stream's
    shape entering each block, the shapes of the parameters as the meshed
    forward reads them, and ``describe()``."""
    from repro_torch.core.tree import leaves_with_paths
    from repro_torch.launch.sharding import MeshPar
    from repro_torch.models import lm
    cfg = _cfg(arch, over)
    p = lm.from_jax_params(cfg, params)
    par = MeshPar(mesh(shape), cfg, moe=moe, ulysses=ulysses,
                  attn_rule=attn_rule)
    placed = par.place_params(p)
    b = _t(batch)
    n, t = next(iter(b.values())).shape[:2]
    with torch.no_grad():
        local = par.local_params(placed, t)
        with _Log(par) as log:
            y = lm.forward(local, cfg, par.local_batch(b), par=par)
        y = par.gather_batch(y, n)
        y0 = lm.forward(p, cfg, b)
        shapes = {k: tuple(v.shape) for k, v in leaves_with_paths(local)}
    return {"meshed": y.numpy(), "unmeshed": y0.numpy(),
            "collectives": par.coll.summary(), "local_shapes": shapes,
            "stream_collectives": log.collectives, "stream": log.stream,
            "dense": par.describe()["dense"], "describe": par.describe()}


def vocab_loss(rank, arch, shape, params, batch, attn_rule="auto"):
    """``loss_fn`` through the meshed forward and the unmeshed one on
    the same weights: the loss and its parts, the whole gradients
    (:func:`_meshed_grads`), the collectives of the meshed loss and its
    backward as ``(kind, shape)``, and ``describe()``."""
    from repro_torch.core.tree import leaves, unflatten
    from repro_torch.launch.sharding import MeshPar
    from repro_torch.models import lm
    cfg = _cfg(arch, {})
    p = lm.from_jax_params(cfg, params)
    par = MeshPar(mesh(shape), cfg, attn_rule=attn_rule)
    placed = par.place_params(p)
    b = _t(batch)
    local = par.local_params(placed, next(iter(b.values())).shape[1])
    with _Log(par) as log:
        live = [x.detach().requires_grad_() for x in leaves(local)]
        loss, aux = lm.loss_fn(unflatten(local, live), cfg,
                               par.local_batch(b), par=par)
        torch.autograd.grad(loss, live)
    live = [x.detach().requires_grad_() for x in leaves(p)]
    loss0, aux0 = lm.loss_fn(unflatten(p, live), cfg, b)
    g0 = unflatten(p, list(torch.autograd.grad(loss0, live)))
    return {"meshed": {"loss": float(loss), **{k: float(v)
                                               for k, v in aux.items()}},
            "unmeshed": {"loss": float(loss0), **{k: float(v)
                                                  for k, v in aux0.items()}},
            "grads": _np_flat(_meshed_grads(par, cfg, placed, b)),
            "grads_unmeshed": _np_flat(g0), "collectives": log.collectives,
            "describe": par.describe()}


def tp_decode(rank, arch, shape, params, prompts, new, attn_rule="auto"):
    """The greedy loop of a session on ``shape`` and of the unmeshed one
    on the same weights: a prefill then ``new`` decode steps, each
    step's logits and tokens, and this rank's cache shapes after the
    prefill; the meshed session's ``describe()["dense"]`` and the
    collectives of its last decode step as ``(kind, shape)``."""
    from repro_torch.core.tree import leaves_with_paths
    from repro_torch.engine import LMConfig, LMSession, SessionConfig
    from repro_torch.models import lm
    cfg = _cfg(arch, {})
    p = lm.from_jax_params(cfg, params)
    lmc = LMConfig(arch=arch, max_context=32, decode_batch=len(prompts))
    out = {}
    for name, m in (("unmeshed", None), ("meshed", mesh(shape))):
        sess = LMSession(config=SessionConfig(backend="cuda-lm",
                                              device="cpu", lm=lmc),
                         params=p, mesh=m, attn_rule=attn_rule)
        logits, handle = sess.prefill(prompts)
        shapes = {k: tuple(v.shape)
                  for k, v in leaves_with_paths(handle.caches)}
        steps = [logits]
        for i in range(new):
            tok = np.argmax(steps[-1], axis=-1).astype(np.int32)
            if m is not None and i == new - 1:
                with _Log(sess.backend.par) as log:
                    steps.append(sess.decode(handle, tok))
                out["decode_collectives"] = log.collectives
            else:
                steps.append(sess.decode(handle, tok))
        out[name] = {"logits": np.stack(steps),
                     "tokens": np.argmax(np.stack(steps), -1),
                     "cache_shapes": shapes}
        if m is not None:
            be = sess.backend
            out["dense"] = be.par.describe()["dense"]
            out["decode_shapes"] = {
                k: tuple(v.shape) for k, v in leaves_with_paths(
                    be.par.local_params(be.params, 1, cached=True))}
    return out


def tp_card(rank, arch, shape, seed, batch):
    """On this rank's card (an NCCL world): the forward of ``arch``'s
    smoke config split over ``shape`` and the unmeshed forward, both
    through the kernel policy's CUDA kernels, from the seeded weights;
    the whole logits, the kernels' launches in the split forward and
    ``describe()["dense"]``."""
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import linear_scan as scan_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import MeshPar
    from repro_torch.models import lm
    from repro_torch.models.stack import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = _cfg(arch, {})
    p = tree_map(lambda t: t.to(dev), init_params(
        cfg, torch.Generator().manual_seed(seed)))
    par = MeshPar(make_mesh(shape, device_type="cuda"), cfg)
    placed = par.place_params(p)
    b = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in batch.items()}
    n = next(iter(b.values())).shape[0]
    with torch.inference_mode():
        before = (flash_mod.launches, scan_mod.launches)
        y = par.gather_batch(lm.forward(placed, cfg, par.local_batch(b),
                                        par=par), n)
        torch.cuda.synchronize()
        launches = {"flash_attention": flash_mod.launches - before[0],
                    "linear_scan": scan_mod.launches - before[1]}
        y0 = lm.forward(p, cfg, b)
    return {"meshed": y.cpu().numpy(), "unmeshed": y0.cpu().numpy(),
            "launches": launches, "dense": par.describe()["dense"]}


def tp_card_train(rank, arch, shape, seed, batch):
    """On this rank's card (an NCCL world): one train step of ``arch``'s
    smoke config split over ``shape`` (the stream over T, the loss over
    the vocabulary) and one of the unmeshed step, from the seeded weights:
    each step's metrics and the meshed ``describe()``."""
    from repro_torch.core.tree import tree_map
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import MeshPar
    from repro_torch.models import lm
    from repro_torch.models.stack import init_params
    from repro_torch.optim import AdamW
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = _cfg(arch, {})
    host = init_params(cfg, torch.Generator().manual_seed(seed))
    par = MeshPar(make_mesh(shape, device_type="cuda"), cfg)
    opt = AdamW()
    b = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in batch.items()}
    out = {}
    for name, pr in (("meshed", par), ("unmeshed", None)):
        p = tree_map(lambda t: t.to(dev, copy=True), host)
        if pr is None:
            state = opt.init(p)
        else:
            p = pr.place_params(p)
            state = pr.init_optimizer(opt, p)
        step = torch.zeros((), dtype=torch.int32, device=dev)
        _, m = lm.make_train_step(cfg, opt, par=pr)((p, state, step), b)
        out[name] = {k: float(v) for k, v in m.items()}
    out["describe"] = par.describe()
    return out


def head_dim_card(rank, arch, shape, seed, prompts, new, batch):
    """On this rank's card (an NCCL world): ``arch``'s smoke config on
    ``shape`` under the default attention rule and unmeshed, from the
    same seeded weights: a ``"cuda-lm"`` session's prefill (the flash
    kernel's launches in it) and ``new`` greedy decode steps (replayed as
    a CUDA graph), their logits and tokens, the decode's mode, this
    rank's cache shapes, ``describe()["dense"]``; and one train step
    each (:func:`tp_card_train`)."""
    from repro_torch.core.tree import leaves_with_paths, tree_map
    from repro_torch.engine import LMConfig, LMSession, SessionConfig
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.stack import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = _cfg(arch, {})
    host = init_params(cfg, torch.Generator().manual_seed(seed))
    lmc = LMConfig(arch=arch, max_context=64, decode_batch=len(prompts))
    out = {}
    for name, m in (("unmeshed", None),
                    ("meshed", make_mesh(shape, device_type="cuda"))):
        sess = LMSession(config=SessionConfig(
            backend="cuda-lm", device=str(dev), lm=lmc),
            params=tree_map(lambda t: t.to(dev, copy=True), host), mesh=m)
        before = flash_mod.launches
        logits, handle = sess.prefill(prompts)
        torch.cuda.synchronize()
        launches = flash_mod.launches - before
        steps = [logits]
        for _ in range(new):
            tok = np.argmax(steps[-1], axis=-1).astype(np.int32)
            steps.append(sess.decode(handle, tok))
        out[name] = {"logits": np.stack(steps),
                     "tokens": np.argmax(np.stack(steps), -1),
                     "launches": launches,
                     "decode": sess.backend.describe()["decode"]}
        if m is not None:
            out["dense"] = sess.backend.par.describe()["dense"]
            out["cache_shapes"] = {k: tuple(v.shape) for k, v in
                                   leaves_with_paths(handle.caches)}
        del sess, handle
    out["train"] = tp_card_train(rank, arch, shape, seed, batch)
    return out


def _meshed_grads(par, cfg, placed, b, raw=None):
    """The gradients the meshed train step takes (the mean of its
    ``cfg.grad_accum`` microbatches', reduced by
    :meth:`MeshPar.reduce_grads`), each leaf's whole value; ``raw``, a
    dict, receives this rank's gradients before the reduction (of
    :meth:`MeshPar.local_params`' tensors) as numpy."""
    from repro_torch.core.tree import leaves, unflatten
    from repro_torch.models import lm
    t = next(iter(b.values())).shape[1]
    whole = par.local_params(placed, t)
    k, gsum = cfg.grad_accum, None
    for micro in lm._split(b, k):
        live = [x.detach().requires_grad_() for x in leaves(whole)]
        loss, _ = lm.loss_fn(unflatten(whole, live), cfg,
                             par.local_batch(micro), par=par)
        g = [x.float() for x in torch.autograd.grad(loss, live)]
        gsum = g if gsum is None else [a + c for a, c in zip(gsum, g)]
    if raw is not None:
        raw.update(_np_flat(unflatten(whole, [x / k for x in gsum])))
    g = par.reduce_grads(unflatten(whole, [x / k for x in gsum]), placed)
    return par.wrap_like(g, placed)


def region_grads(rank, arch, over, shape, moe, ulysses, params, batch):
    """The loss's gradients through the meshed forward (every rank's
    whole gradient tree) and through the unmeshed one."""
    from repro_torch.core.tree import leaves, unflatten
    from repro_torch.launch.sharding import MeshPar
    from repro_torch.models import lm
    cfg = _cfg(arch, over)
    p = lm.from_jax_params(cfg, params)
    par = MeshPar(mesh(shape), cfg, moe=moe, ulysses=ulysses)
    b = _t(batch)
    live = [t.detach().requires_grad_() for t in leaves(p)]
    loss, _ = lm.loss_fn(unflatten(p, live), cfg, b)
    g = unflatten(p, list(torch.autograd.grad(loss, live)))
    return {"meshed": _np_flat(_meshed_grads(par, cfg, par.place_params(p),
                                             b)),
            "unmeshed": _np_flat(g)}


def train(rank, arch, over, shape, state, batches, lr, attn_rule="auto"):
    """Steps of the meshed train step from the carried JAX train state:
    after each, the summed gradients, the metrics, and the whole
    parameters and moments."""
    from repro_torch.launch.sharding import MeshPar
    from repro_torch.models import lm
    from repro_torch.optim import AdamW, warmup_cosine
    cfg = _cfg(arch, over)
    par = MeshPar(mesh(shape), cfg, attn_rule=attn_rule)
    params, opt_state, step = lm.from_jax_train_state(cfg, state)
    opt = AdamW(learning_rate=warmup_cosine(*lr))
    placed = par.place_params(params)
    opt_state = opt_state._replace(mu=par.place_params(opt_state.mu),
                                   nu=par.place_params(opt_state.nu))
    train_step = lm.make_train_step(cfg, opt, par=par)
    out = []
    for nb in batches:
        b = _t(nb)
        # the gradients the step sums, for the parity marks, and this
        # rank's before their reduction, with the collectives they took
        raw = {}
        with _Log(par) as log:
            g = _meshed_grads(par, cfg, placed, b, raw)
        (placed, opt_state, step), m = train_step(
            (placed, opt_state, step), b)
        out.append({"grads": _np_flat(g), "raw_grads": raw,
                    "collectives": log.collectives,
                    "metrics": {k: float(v) for k, v in m.items()},
                    "params": _np_flat(placed),
                    "mu": _np_flat(opt_state.mu),
                    "nu": _np_flat(opt_state.nu)})
    return out


def compress(rank, grads, steps):
    """``compress_allreduce`` over the world's ranks (a 1-D 'pod' mesh),
    ``steps`` times with error feedback, on this rank's gradients."""
    from repro_torch.launch.collectives import Collectives
    from repro_torch.optim.compress import compress_allreduce
    from repro_torch.launch.mesh import make_mesh
    n = next(iter(grads.values()))[0].shape[0]  # the ranks' gradients
    key = ("pod", n)
    if key not in _MESHES:
        _MESHES[key] = make_mesh((n,), axes=("pod",), device_type="cpu")
    group = Collectives(_MESHES[key]).on("pod")
    residual, out = None, []
    for i in range(steps):
        g = {k: torch.from_numpy(np.array(v[i][rank])) for k, v in
             grads.items()}
        mean, residual = compress_allreduce(g, residual, group=group)
        out.append({"mean": {k: v.numpy() for k, v in mean.items()},
                    "residual": {k: v.numpy() for k, v in residual.items()}})
    return out


def save_state(rank, arch, shape, seed, ckpt_dir):
    """The seeded parameters placed on ``shape`` and saved (rank 0
    writes the whole values)."""
    from repro_torch.checkpoint import save
    from repro_torch.launch.sharding import MeshPar
    from repro_torch.models.stack import init_params
    cfg = _cfg(arch, {})
    par = MeshPar(mesh(shape), cfg)
    params = init_params(cfg, torch.Generator().manual_seed(seed))
    save(ckpt_dir, 1, {"params": par.place_params(params)})
    return True


def restore_state(rank, arch, shape, ckpt_dir):
    """The checkpoint restored onto ``shape`` by its param specs: each
    leaf's whole value, and this rank's block shapes."""
    from repro_torch.checkpoint import restore
    from repro_torch.launch.sharding import MeshPar, to_named
    from repro_torch.models.stack import init_params
    cfg = _cfg(arch, {})
    m = mesh(shape)
    par = MeshPar(m, cfg)
    like = {"params": init_params(cfg, device="meta")}
    sh = {"params": to_named(m, par.param_specs(like["params"]),
                             like["params"])}
    got = restore(ckpt_dir, 1, like, shardings=sh)
    from repro_torch.core.tree import leaves_with_paths
    return {"whole": _np_flat(got),
            "local_shapes": {k: tuple(v.to_local().shape)
                             for k, v in leaves_with_paths(got)}}
