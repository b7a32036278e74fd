"""Training over a data x model mesh: the port's FSDP on ``data``, the
batch over ``("pod", "data")`` and its global loss, against the JAX
package on the same mesh and the same numpy inputs; then the port
alone: the mesh, the FSDP gather under remat, AdamW on the same
gradients, elastic checkpoints across meshes and the trainer's CLI.

The JAX half runs in one subprocess, this file's ``__main__`` block, on
4 fake CPU devices (the fake-device count must be set before JAX
starts), on meshes whose axes are ``AxisType.Auto`` (jax 0.9's default
Explicit axes refuse the train step's sharding constraints: ROADMAP
queue 3), at float32 compute. It also computes each family on one
device: where a family's data-mesh step raises, the port is held
against that (GSPMD computes the unsharded function) and the failure is
printed. The port's ranks are CPU ranks of one mesh
(``launch.mesh.make_host_mesh``).

Tolerances, with their reasons (``test_torch_multirank_train.py``'s):
* specs, per-rank shapes, degradations, ``shard_tree`` then
  ``unshard_tree``: exact;
* the model (float32 smoke): the loss within 1e-5 relative; every
  gradient leaf (its distinct blocks joined, the copies of a block
  summed) within 1e-3 of its largest |entry|, plus JAX's own gap
  between its data-mesh and its one-device gradients (the logits are
  bf16 in both packages, so an fp32 sum in another order can move a
  logit by one bf16 ulp, 2**-8, and the one-ulp step spreads through
  the backward's sums; JAX's own gradients move with the mesh too);
  rwkv6-smoke is held against JAX's float64 run (the reference with
  every float32 and bf16 cast lifted to float64: its modules' ``jnp``
  with those dtypes mapped to float64), within 1e-3 plus the distance
  of JAX's own float32 gradient from it, leaf by leaf: on this batch
  every leaf of the float32 gradient moves as one, JAX's 3.7% and the
  port's 0.9% of its largest |entry| from the float64 one, an error of
  float32 arithmetic on this input, not a difference of the two
  packages (ROADMAP queue 3);
* rwkv6-smoke with every cast lifted to float64 in both packages, the
  port on the (2, 1) mesh: the loss within 1e-12 relative and every
  gradient leaf within 1e-9 of its largest |entry| (measured 4.7e-11:
  the same function, summed in another order);
* a batch that does not divide by the data groups (2 rows at (4, 1)):
  the loss within 1e-6 relative and every gradient leaf within 1e-5 of
  its largest |entry| of the port's one-rank run (each group runs the
  same rows; the sums of four equal copies round once more);
* two AdamW steps at (2, 2) against JAX's ``jitted_train_step`` on the
  same mesh: the first step's loss 1e-5 and grad norm 1e-3, the second
  step's loss 1e-3 and grad norm 2e-2, every leaf within 0.3 of the
  norm of its update and 4 x the sum of the lrs entry by entry; against
  the port at (1, 1) the same bounds, by the same argument (measured
  1.03e-5 on the second loss, 4.1e-3 on its grad norm and 1.0e-2 of
  wk's update: the first update moved the entries whose gradients sit
  near eps by their rounding; AdamW's g / (|g| + eps) argument of
  ``test_torch_multirank_train.py``). On the same gradients the (2, 2)
  step equals the (1, 1) step within 1e-6 of each leaf's largest
  |entry| (the global norm sums the blocks' squares in another order);
* elastic checkpoints (float32 smoke, (2, 2) -> (1, 1) -> (4, 1)
  against (2, 2) uninterrupted): losses 1e-5 relative, every parameter
  leaf within 2e-2 of the norm of its six-step update; JAX's trainer
  resuming the port's (2, 2) checkpoint: losses 2e-3 relative (bf16
  smoke);
* the CLI at ``--devices cpu,cpu,cpu,cpu --tp 2`` against ``--tp 1``
  (bf16 smoke): losses 2e-3 relative (bf16 partial sums round at other
  places over the model ranks).
"""
import contextlib
import os
import pathlib
import subprocess
import sys

import numpy as np

MESHES = ((2, 1), (2, 2), (4, 1))
SPEC_ARCHS = ("llama3-8b", "olmoe-1b-7b", "mixtral-8x22b", "zamba2-1.2b",
              "rwkv6-3b", "paligemma-3b", "hubert-xlarge")
# (arch, (data, model), fusion mode, batch rows)
LOSS_CASES = (("llama3-8b", (2, 1), "ring", 4),
              ("llama3-8b", (2, 2), "ring", 4),
              ("llama3-8b", (4, 1), "ring", 4),
              ("llama3-8b", (2, 2), "bsp", 4),
              ("llama3-8b", (4, 1), "ring", 2),    # rows do not divide
              ("olmoe-1b-7b", (2, 2), "ring", 4),
              ("zamba2-1.2b", (2, 1), "ring", 4),
              ("rwkv6-3b", (2, 1), "ring", 4),
              ("paligemma-3b", (2, 1), "ring", 4))
SEQ = 32
LR = 1e-3
# families whose float32 gradients on this batch lie further from the
# exact ones than the bound: held against JAX's float64 run
F64_ARCHS = ("rwkv6-3b",)
ADAM_MESH = (2, 2)


def case_id(arch, mesh, mode, rows):
    return f"{arch}/{mesh[0]}x{mesh[1]}/{mode}/{rows}"


def train_batch(cfg, rows):
    r = np.random.default_rng(0)
    out = {"tokens": r.integers(0, cfg.vocab_size, size=(rows, SEQ))
           .astype(np.int32),
           "labels": r.integers(0, cfg.vocab_size, size=(rows, SEQ))
           .astype(np.int32)}
    out["labels"][0, :3] = -100                      # ignored positions
    out["labels"][-1, 5:] = -100      # the groups count other tokens
    if cfg.family == "vlm":
        out["patches"] = r.standard_normal(
            (rows, cfg.num_prefix_tokens, cfg.frontend_dim),
            dtype=np.float32)
    return out


def spec_repr(spec) -> str:
    """A spec as text, the same for JAX's ``PartitionSpec`` and the
    port's tuple."""
    return repr(tuple(None if e is None else e if isinstance(e, str)
                      else tuple(e) for e in spec))


@contextlib.contextmanager
def lifted_casts(package, lib, names, to):
    """Within the block, the modules of ``package``'s ``models``,
    ``core`` and ``distributed`` that use ``lib`` (``jax.numpy`` or
    ``torch``) see it with the dtypes ``names`` mapped to ``to``: the
    explicit float32 and bf16 casts lifted to float64."""
    import importlib
    import pkgutil

    class Lifted:
        def __getattr__(self, k):
            return to if k in names else getattr(lib, k)
    mods = []
    for sub in ("models", "core", "distributed"):
        pk = importlib.import_module(f"{package}.{sub}")
        for m in pkgutil.iter_modules(pk.__path__):
            mod = importlib.import_module(f"{pk.__name__}.{m.name}")
            for attr, v in vars(mod).items():
                if v is lib:
                    mods.append((mod, attr))
    for mod, attr in mods:
        setattr(mod, attr, Lifted())
    try:
        yield
    finally:
        for mod, attr in mods:
            setattr(mod, attr, lib)


def _oracle(path):
    """The JAX half: writes every input and output to ``path``."""
    import traceback

    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding

    from repro.configs import get_config, smoke_config
    from repro.distributed import context as dctx
    from repro.distributed.sharding_rules import rules_for
    from repro.launch import steps
    from repro.models import lm
    from repro.optim import adamw

    def mesh_of(D, W):
        return jax.make_mesh((D, W), ("data", "model"),
                             devices=jax.devices()[:D * W],
                             axis_types=(AxisType.Auto,) * 2)

    def keys(tree):
        return [(".".join(str(x.key) for x in k), v)
                for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]]

    out = {}
    for arch in SPEC_ARCHS:
        cfg = smoke_config(get_config(arch))
        shapes = dict(keys(steps.param_specs(cfg)))
        for D, W in MESHES:
            rules = rules_for(cfg, mesh_of(D, W))
            psh = steps.param_shardings(cfg, rules)
            c = f"spec/{arch}/{D}x{W}"
            for name, s in keys(psh):
                out[f"{c}/spec/{name}"] = np.array(spec_repr(s.spec))
                out[f"{c}/shape/{name}"] = np.array(
                    s.shard_shape(shapes[name].shape))
            out[f"{c}/degradations"] = np.array(rules.degradations + [""])
            bs = steps.batch_sharding(rules, {
                "even": jax.ShapeDtypeStruct((4, SEQ), jnp.int32),
                "odd": jax.ShapeDtypeStruct((3, SEQ), jnp.int32)})
            for k, s in bs.items():
                out[f"{c}/batch/{k}"] = np.array(spec_repr(s.spec))

    done, inits = set(), {}
    for arch, (D, W), mode, rows in LOSS_CASES:
        cfg = smoke_config(get_config(arch)).replace(dtype=jnp.float32)
        params = lm.init_params(jax.random.PRNGKey(0), cfg)
        if arch not in done:
            done.add(arch)
            inits[arch] = params
            for k, v in keys(params):
                out[f"p/{arch}/{k}"] = np.asarray(v)
        b = train_batch(cfg, rows)
        c = case_id(arch, (D, W), mode, rows)
        for where, (d, w) in (("one", (1, 1)), ("mesh", (D, W))):
            mesh = mesh_of(d, w)
            rules = rules_for(cfg, mesh)
            ctx = dctx.make_context(mesh, fusion_mode=mode, rules=rules)
            try:
                with dctx.use(ctx), mesh:
                    p = jax.device_put(params,
                                       steps.param_shardings(cfg, rules))
                    bsh = steps.batch_sharding(rules, b)
                    batch = {k: jax.device_put(jnp.asarray(v), bsh[k])
                             for k, v in b.items()}
                    (loss, met), grads = jax.jit(jax.value_and_grad(
                        lambda p, x: lm.loss_fn(p, x, cfg),
                        has_aux=True))(p, batch)
            except Exception:               # the family's known defect
                print(f"JAX {c} at {d}x{w} raised:", file=sys.stderr)
                traceback.print_exc()
                continue
            out[f"{c}/{where}/loss"] = np.asarray(loss)
            out[f"{c}/{where}/aux"] = np.asarray(met["aux"])
            for k, v in keys(grads):
                out[f"{c}/{where}/g/{k}"] = np.asarray(v)

    cfg = smoke_config(get_config("llama3-8b")).replace(dtype=jnp.float32)
    params = lm.init_params(jax.random.PRNGKey(0), cfg)
    mesh = mesh_of(*ADAM_MESH)
    jitted, ctx, psh, osh = steps.jitted_train_step(
        cfg, mesh, adamw.AdamWConfig(lr=LR), fusion_mode="ring",
        donate=False)
    b = train_batch(cfg, 4)
    with dctx.use(ctx), mesh:
        p = jax.device_put(params, psh)
        o = jax.device_put(adamw.init_state(params), osh)
        bsh = steps.batch_sharding(ctx.rules, b)
        batch = {k: jax.device_put(jnp.asarray(v), bsh[k])
                 for k, v in b.items()}
        for step in range(2):
            p, o, met = jitted(p, o, batch)
            out[f"adam/loss{step}"] = np.asarray(met["loss"])
            out[f"adam/gnorm{step}"] = np.asarray(met["grad_norm"])
    assert isinstance(p["ln_f"]["scale"].sharding, NamedSharding)
    for k, v in keys(p):
        out[f"adam/p/{k}"] = np.asarray(v)

    # last, as it turns float64 on for the process: the F64_ARCHS on one
    # device with every float32 and bf16 cast of the reference lifted
    jax.config.update("jax_enable_x64", True)
    for arch in F64_ARCHS:
        cfg = smoke_config(get_config(arch)).replace(dtype=jnp.float64)
        params = jax.tree.map(lambda v: jnp.asarray(np.asarray(v),
                                                    jnp.float64),
                              inits[arch])
        b = {k: jnp.asarray(v) for k, v in train_batch(cfg, 4).items()}
        with lifted_casts("repro", jnp, ("float32", "bfloat16"),
                          jnp.float64):
            (loss, met), grads = jax.value_and_grad(
                lambda p: lm.loss_fn(p, b, cfg), has_aux=True)(params)
        out[f"f64/{arch}/loss"] = np.asarray(loss)
        for k, v in keys(grads):
            out[f"f64/{arch}/g/{k}"] = np.asarray(v)
    np.savez(path, **out)


if __name__ == "__main__":
    _oracle(sys.argv[1])
    sys.exit(0)


# ------------------------------------------------------------ the port
import pytest  # noqa: E402

torch = pytest.importorskip("torch")

from repro.launch import train as jtrain  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data.pipeline import shard_batch  # noqa: E402
from repro_torch.distributed import fsdp  # noqa: E402
from repro_torch.distributed import sharding_rules as tsr  # noqa: E402
from repro_torch.distributed.context import (DistContext, Mesh,  # noqa: E402
                                             use)
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.module import tree_items  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def oracle_run(tmp_path_factory):
    """Starts the JAX half when the module's first test starts, so the
    port-only tests run while it computes."""
    out = tmp_path_factory.mktemp("oracle") / "data_mesh.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen([sys.executable, __file__, str(out)], env=env)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def jx(oracle_run):
    proc, out = oracle_run
    assert proc.wait(timeout=900) == 0, "the JAX half failed"
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _t(x):
    return torch.from_numpy(np.array(x))


def _mesh(D, W):
    return tmesh.make_host_mesh(D, W, device="cpu")


def _cfg(arch="llama3-8b", **kw):
    return smoke_config(get_config(arch)).replace(dtype=torch.float32, **kw)


def _tree(jx, prefix):
    tree: dict = {}
    for key, v in jx.items():
        if not key.startswith(prefix):
            continue
        node = tree
        *path, leaf = key[len(prefix):].split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def _leaf_close(got, want, frac, what, extra=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= frac * scale + extra, \
        f"{what}: max err {err:.3e} > {frac} x {scale:.3e} + {extra:.3e}"


def _batch(cfg, rows, mesh=None):
    """The test batch as ``shard_batch`` places it over ``mesh``."""
    return shard_batch(train_batch(cfg, rows), "cpu", mesh)


def _global_grads(ps, cfg, mesh):
    """Every leaf's global gradient: each distinct block's copies
    summed, the blocks joined (what JAX's gradient holds)."""
    specs = tlm.leaf_specs(cfg, mesh)
    coords = tsr.rank_coords(mesh.shape)
    named = [dict(p.named_parameters()) for p in ps]
    out = {}
    for n, s in specs.items():
        keys = [_block(s, c, mesh) for c in coords]
        sums: dict = {}
        for k, nm in zip(keys, named):
            g = nm[n].grad
            sums[k] = g.clone() if k not in sums else sums[k] + g
        out[n] = tsr.join([sums[k] for k in keys], s, mesh.shape).numpy()
    return out


def _axes(spec) -> set:
    return {a for e in spec for a in ((e,) if isinstance(e, str)
                                      else (e or ()))}


def _block(spec, coords, mesh) -> tuple:
    """Which block of a leaf cut by ``spec`` the rank at ``coords``
    holds: its coordinates on the axes that cut it."""
    return tuple(coords[a] for a in sorted(_axes(spec)))


def _flat(tree, prefix=""):
    """``{dotted path: leaf}`` of a ``steps`` sharding tree (its leaves
    are the dicts holding "spec")."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out.update({path: v} if "spec" in v else _flat(v, path))
    return out


# ---------------------------------------------------------------- mesh
def test_mesh_axes_coords_and_groups():
    """Row-major ranks over (pod, data, model), as ``jax.make_mesh``
    orders devices: coordinates, the axis groups (JAX's psum groups),
    the data groups' model-only sub-meshes, and every size reader."""
    m = Mesh(["cpu"] * 12, (2, 3, 2), ("pod", "data", "model"))
    assert m.shape == {"pod": 2, "data": 3, "model": 2}
    assert (m.size, m.model, m.dp) == (12, 2, 6)
    assert m.coords(7) == {"pod": 1, "data": 0, "model": 1}
    assert [m.coords(r)["data"] for r in range(6)] == [0, 0, 1, 1, 2, 2]
    assert m.axis_groups("data") == [[0, 2, 4], [1, 3, 5], [6, 8, 10],
                                     [7, 9, 11]]
    assert m.axis_groups(("pod", "data"))[0] == [0, 2, 4, 6, 8, 10]
    assert m.axis_groups("model")[5] == [10, 11]
    g = m.group(4)
    assert g is m.group(4) and g.shape == {"model": 2} and g.size == 2
    assert DistContext(m).model_axis_size == 2
    one = _mesh(1, 4)
    assert one.group(0) is one and one.dp == 1
    assert tsr.rules_for(None, m).shape == m.shape
    with pytest.raises(ValueError, match="in that order"):
        Mesh(["cpu"] * 4, (2, 2), ("model", "data"))
    with pytest.raises(ValueError, match="holds 6 ranks"):
        Mesh(["cpu"] * 4, (3, 2))


def test_launch_meshes_are_jax_shapes():
    """``make_mesh`` is JAX's ``build_mesh`` (data = n // model), the
    elastic and the production meshes JAX's shapes, as virtual ranks."""
    m = tmesh.make_mesh(2, "cpu,cpu,cpu,cpu")
    assert m.shape == {"data": 2, "model": 2}
    assert tmesh.make_mesh(4, device="cpu").shape == {"data": 1, "model": 4}
    with pytest.raises(ValueError, match="one device per rank"):
        tmesh.make_mesh(2, "cpu,cpu,cpu")
    assert tmesh.make_mesh_for_devices(8, 2, 2, device="cpu").shape == \
        {"pod": 2, "data": 2, "model": 2}
    assert tmesh.make_mesh_for_devices(8, 4, device="cpu").shape == \
        {"data": 2, "model": 4}
    with pytest.raises(ValueError):
        tmesh.make_mesh_for_devices(8, 3, device="cpu")
    p = tmesh.make_production_mesh(device="cpu")
    assert p.shape == {"data": 16, "model": 16} and p.size == 256
    p = tmesh.make_production_mesh(multi_pod=True, device="cpu")
    assert p.shape == {"pod": 2, "data": 16, "model": 16} and p.dp == 32


def test_serving_refuses_a_data_axis(monkeypatch):
    """Serving takes the data axis now (the name is the old refusal's):
    ``launch.serve --smoke --devices cpu,cpu,cpu,cpu --tp 2`` serves on
    a (2, 2) mesh (each rank's shards, weights-stationary decode), and
    so does ``--tp 1`` over four devices (4, 1); their greedy float32
    streams equal ``--tp 1`` on one device. ``jitted_serve_step`` takes
    a data mesh."""
    from repro_torch.launch import serve
    monkeypatch.setattr(serve, "smoke_config", lambda c: smoke_config(
        c).replace(dtype=torch.float32))
    base = ["--arch", "llama3-8b", "--smoke", "--device", "cpu",
            "--requests", "4", "--batch", "2", "--max-new", "4",
            "--max-len", "32", "--fusion-mode", "ring"]
    want = serve.main(base + ["--tp", "1"])
    got = serve.main(base + ["--devices", "cpu,cpu,cpu,cpu", "--tp", "2"])
    assert got["mesh"] == {"data": 2, "model": 2}
    assert got["streams"] == want["streams"] and len(want["streams"]) == 4
    got = serve.main(base + ["--devices", "cpu,cpu,cpu,cpu", "--tp", "1"])
    assert got["mesh"] == {"data": 4, "model": 1}
    assert got["streams"] == want["streams"]
    assert tmesh.make_mesh(2, "cpu,cpu").shape == {"data": 1, "model": 2}
    fn, ctx, _ = tsteps.jitted_serve_step(_cfg(), _mesh(2, 2))
    assert ctx.mesh.dp == 2


# ------------------------------------------------------------ FSDP gather
@pytest.mark.parametrize("policy", ["full", "dots", None])
def test_fsdp_gather_runs_per_layer_and_again_in_the_backward(
        monkeypatch, policy):
    """Each layer's FSDP leaves are gathered inside its remat scope: the
    backward gathers every layer's again under "full" and "dots" (the
    gather is no product, so "dots" recomputes it), and not without
    remat; the gradients are the same under the three."""
    cfg = _cfg(remat=policy is not None, remat_policy=policy or "full")
    m = _mesh(2, 2)
    calls = []
    real = fsdp.gather

    def counted(blocks, dim, device):
        calls.append(torch.is_grad_enabled())
        return real(blocks, dim, device)
    monkeypatch.setattr(fsdp, "gather", counted)
    ps = tlm.init_params(cfg, seed=3, device="cpu", trainable=True, mesh=m)
    with use(DistContext(m, "ring")):
        loss, _ = tlm.loss_fn(ps, _batch(cfg, 4, m), cfg)
        n_fwd = len(calls)
        loss.backward()
    n_bwd = len(calls) - n_fwd
    per_layer = sum(1 for d in tlm.data_dims(cfg, m).values()
                    if d is not None)
    top = sum(1 for k, d in tlm.data_dims(cfg, m).items()
              if d is not None and not k.startswith("backbone"))
    layers = (per_layer - top) * cfg.n_layers
    # two groups, W = 2 ranks each gather every leaf
    assert n_fwd == 2 * 2 * (layers + top)
    assert n_bwd == (2 * 2 * layers if policy else 0)
    monkeypatch.setattr(fsdp, "gather", real)
    ref = tlm.init_params(cfg.replace(remat=False), seed=3, device="cpu",
                          trainable=True, mesh=m)
    with use(DistContext(m, "ring")):
        tlm.loss_fn(ref, _batch(cfg, 4, m), cfg.replace(remat=False))[0] \
            .backward()
    for p, q in zip(ps, ref):
        for (n, x), (_, y) in zip(p.named_parameters(), q.named_parameters()):
            _leaf_close(x.grad, y.grad, 1e-6, n)


# ---------------------------------------------------------------- AdamW
def _two_steps(tree, mesh):
    cfg = _cfg()
    ps = params_from_numpy(tree, cfg, device="cpu", trainable=True,
                           mesh=mesh)
    opt = tsteps.init_opt_state(ps)
    step = tsteps.make_train_step(cfg, tadamw.AdamWConfig(lr=LR))
    ms = []
    with use(DistContext(mesh, "ring")):
        for _ in range(2):
            ps, opt, m = step(ps, opt, _batch(cfg, 4, mesh))
            ms.append({k: v.item() for k, v in m.items()})
    return ps, opt, ms


def _nest(flat):
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *keys, leaf = path.split(".")
        for k in keys:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


@pytest.mark.parametrize("mesh", [(2, 2), (4, 1), (2, 1)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_adamw_on_the_mesh_equals_one_rank_on_the_same_grads(mesh):
    """Two steps of ``apply_updates_ranks`` on the mesh's blocks of one
    set of gradients (each block's gradient split unevenly over its
    copies) against ``apply_updates`` at one rank: parameters, m and v
    within 1e-6 of each leaf's largest |entry|; copies bit-identical."""
    cfg, m = _cfg(), _mesh(*mesh)
    p1 = tlm.param_tree(tlm.init_params(cfg, seed=5, device="cpu",
                                        trainable=True))
    ps = [tlm.param_tree(p) for p in tlm.shard_params(
        tlm.from_tree(cfg, p1, trainable=True), m)]
    specs = tlm.leaf_specs(cfg, m)
    coords = tsr.rank_coords(m.shape)
    o1 = tadamw.init_state(p1)
    os_ = [tadamw.init_state(p) for p in ps]
    opt = tadamw.AdamWConfig(lr=LR)
    for step in range(2):
        g1 = {n: _t(np.random.default_rng(20 + step).normal(
            size=tuple(t.shape)).astype(np.float32))
            for n, t in tree_items(p1)}
        gs = [{} for _ in coords]
        for n, g in g1.items():
            s = specs[n]
            copies: dict = {}
            for r, c in enumerate(coords):
                copies.setdefault(_block(s, c, m), []).append(r)
            for ranks in copies.values():
                k = len(ranks)
                for j, r in enumerate(ranks):
                    gs[r][n] = (tsr.cut(g, s, coords[r], m.shape) * (j + 1)
                                / (k * (k + 1) / 2)).clone()
        m1 = tadamw.apply_updates(p1, _nest(g1), o1, opt)
        mw = tadamw.apply_updates_ranks(ps, [_nest(g) for g in gs], os_,
                                        opt, specs, m.shape)
        assert float(m1["grad_norm"]) > opt.grad_clip      # clipped
        np.testing.assert_allclose(float(mw["grad_norm"]),
                                   float(m1["grad_norm"]), rtol=1e-6)
    for part, one, ranks in (("params", p1, ps),
                             ("m", o1["m"], [o["m"] for o in os_]),
                             ("v", o1["v"], [o["v"] for o in os_])):
        trees = [dict(tree_items(t)) for t in ranks]
        for n, want in tree_items(one):
            got = tsr.join([t[n] for t in trees], specs[n], m.shape)
            _leaf_close(got.detach(), want.detach(), 1e-6, f"{part} {n}")
            for t, c in zip(trees, coords):
                assert torch.equal(t[n], tsr.cut(got, specs[n], c, m.shape)), \
                    (part, n)


# ------------------------------------------------------------ checkpoints
RUN = ["--arch", "llama3-8b", "--smoke", "--batch", "4", "--seq", "16",
       "--log-every", "1", "--device", "cpu", "--warmup", "8"]


def _devs(n):
    return ["--devices", ",".join(["cpu"] * n)]


def _train(cfg, argv, **kw):
    return ttrain.train(cfg, ttrain.parse_args(RUN + argv), **kw)


def _only_step(src, step, dst):
    import shutil
    name = f"step_{step:08d}"
    os.makedirs(dst, exist_ok=True)
    shutil.copytree(os.path.join(src, name), os.path.join(dst, name))
    return str(dst)


def test_elastic_checkpoint_two_by_two_one_four_equals_uninterrupted(
        tmp_path):
    """float32 smoke: 6 steps at (2, 2), against 2 steps at (2, 2), 2
    more resumed at (1, 1) and the last 2 resumed at (4, 1) (warmup 8 >
    steps, so the lr schedule does not depend on the total). The files
    hold the global arrays."""
    cfg = _cfg()
    full = _train(cfg, ["--steps", "6", "--tp", "2", "--fusion-mode",
                        "ring", *_devs(4)])
    d = str(tmp_path / "ck")
    _train(cfg, ["--steps", "2", "--tp", "2", "--fusion-mode", "ring",
                 *_devs(4), "--ckpt-dir", d, "--ckpt-every", "2"])
    b = _train(cfg, ["--steps", "4", "--tp", "1", "--ckpt-dir", d,
                     "--resume"])
    c = _train(cfg, ["--steps", "6", "--tp", "1", *_devs(4), "--ckpt-dir",
                     d, "--resume"])
    assert (b["start_step"], c["start_step"]) == (2, 4)
    np.testing.assert_allclose([m["loss"] for m in b["log"] + c["log"]],
                               [m["loss"] for m in full["log"][2:]],
                               rtol=1e-5)
    got = tlm.gather_params(c["params"], _mesh(4, 1))
    want = tlm.gather_params(full["params"], _mesh(2, 2))
    init = dict(tlm.init_params(cfg, seed=0, device="cpu").named_parameters())
    for (n, x), (_, y) in zip(got.named_parameters(),
                              want.named_parameters()):
        rel = ((x - y).norm() / (y - init[n]).norm()).item()
        assert rel <= 2e-2, f"{n}: {rel:.3e} of the update"
    flat, _ = Checkpointer(d).read()
    assert tuple(flat["params%%backbone%%layers%%attn%%wq"].shape) == \
        (4, 128, 128)
    assert tuple(flat["opt%%m%%embed%%table"].shape) == (512, 128)


def test_jax_trainer_resumes_the_ports_two_by_two_checkpoint(tmp_path):
    """The port's bf16 smoke run at (2, 2): its step-2 checkpoint resumed
    by JAX's trainer continues the port's curve."""
    argv = ["--arch", "llama3-8b", "--smoke", "--batch", "4", "--seq",
            "32", "--log-every", "1", "--warmup", "8"]
    d = tmp_path / "ck"
    port = ttrain.main(argv + ["--steps", "4", "--device", "cpu", "--tp",
                               "2", *_devs(4), "--ckpt-dir", str(d),
                               "--ckpt-every", "2"])
    jl = jtrain.main(argv + ["--steps", "4", "--resume", "--ckpt-dir",
                             _only_step(d, 2, tmp_path / "jax")])
    assert [m["step"] for m in jl] == [2, 3]
    np.testing.assert_allclose([m["loss"] for m in jl],
                               [m["loss"] for m in port[2:]], rtol=2e-3)


# ------------------------------------------------------------------ CLI
def test_cli_data_mesh_matches_tp1(tmp_path):
    """``python -m repro_torch.launch.train --devices cpu,cpu,cpu,cpu
    --tp 2`` (bf16 smoke, a (2, 2) mesh) against ``--tp 1``; a device
    count that does not divide by ``--tp`` and, in one process, the
    production meshes (16 and 32 processes) raise."""
    argv = ["--arch", "llama3-8b", "--smoke", "--device", "cpu", "--batch",
            "4", "--seq", "32", "--log-every", "1", "--warmup", "8",
            "--steps", "3"]
    mf = tmp_path / "m.json"
    subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                    *argv, "--tp", "2", *_devs(4), "--metrics-file",
                    str(mf)], env=dict(os.environ,
                                       PYTHONPATH=str(REPO / "src")),
                   check=True, timeout=300)
    import json
    mesh = [m["loss"] for m in json.loads(mf.read_text())]
    tp1 = [m["loss"] for m in ttrain.main(argv)]
    assert len(mesh) == 3
    np.testing.assert_allclose(mesh, tp1, rtol=2e-3)
    with pytest.raises(ValueError, match="do not divide by --tp 2"):
        ttrain.main(argv + ["--tp", "2", *_devs(3)])
    for extra, n in ((["--mesh", "production"], 16), (["--multi-pod"], 32)):
        with pytest.raises(ValueError, match=f"over {n} processes"):
            ttrain.main(argv + ["--tp", "2", *_devs(4)] + extra)


# --------------------------------------------------------------- specs
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_specs_shapes_and_degradations_match_jax(jx, arch, mesh):
    """Every leaf's spec and per-rank shape (``steps.param_shardings``
    and the tensors ``lm.shard_params`` cuts on every rank) equal JAX's
    ``param_shardings`` specs and ``shard_shape``, with the same
    degradations; the batch's spec is JAX's ``batch_sharding``; and
    ``shard_tree`` then ``unshard_tree`` gives the tree back bit for
    bit."""
    cfg = smoke_config(get_config(arch))
    m = _mesh(*mesh)
    c = f"spec/{arch}/{mesh[0]}x{mesh[1]}"
    rules = tsr.rules_for(cfg, m)
    psh = tsteps.param_shardings(cfg, rules)
    got = _flat(psh)
    want = _tree(jx, f"{c}/shape/")
    assert set(got) == {k for k, _ in tree_items(want)}
    for path, v in got.items():
        assert spec_repr(v["spec"]) == str(jx[f"{c}/spec/{path}"]), path
        assert tuple(v["shape"]) == tuple(jx[f"{c}/shape/{path}"]), path
    assert rules.degradations + [""] == list(jx[f"{c}/degradations"])
    params = tlm.init_params(cfg, seed=1, device="cpu", trainable=True)
    shards = tlm.shard_params(params, m)
    assert len(shards) == m.size
    for s in shards:
        for path, t in tree_items(tlm.param_tree(s)):
            assert tuple(t.shape) == tuple(jx[f"{c}/shape/{path}"]), path
    back = tlm.gather_params(shards, m)
    for (n, x), (_, y) in zip(back.named_parameters(),
                              params.named_parameters()):
        assert torch.equal(x, y), n
    bs = tsteps.batch_sharding(rules, {"even": torch.empty(4, SEQ),
                                       "odd": torch.empty(3, SEQ)})
    for k, v in bs.items():
        assert spec_repr(v["spec"]) == str(jx[f"{c}/batch/{k}"]), k


def test_full_width_llama_rank_bytes_are_the_rules():
    """Full-width llama3-8b cut to 4 layers: 480,808,960 fp32 master
    entries a rank at (2, 2), as at (1, 4) and (4, 1) (JAX's
    ``shard_shape`` over ``param_shardings``); 36,864 norm-scale
    entries replicated."""
    from repro_torch.configs import get_config as gc
    cfg = gc("llama3-8b").replace(n_layers=4)
    spec = dict(tree_items(tlm.lm_spec(cfg)))
    for D, W in ((2, 2), (1, 4), (4, 1)):
        m = _mesh(D, W)
        psh = _flat(tsteps.param_shardings(cfg, tsr.rules_for(cfg, m)))
        n = sum(int(np.prod(v["shape"])) for v in psh.values())
        assert n == 480_808_960, (D, W, n)
        rep = sum(int(np.prod(spec[k].shape)) for k, v in psh.items()
                  if not any(v["spec"]))
        assert rep == 36_864


# ------------------------------------------------------- loss and grads
def _port_loss(cfg, tree, mesh, mode, batch):
    ps = params_from_numpy(tree, cfg, device="cpu", trainable=True,
                           mesh=mesh)
    with use(DistContext(mesh if mesh is not None and mesh.size > 1
                         else None, mode)):
        loss, met = tlm.loss_fn(ps, shard_batch(batch, "cpu", mesh), cfg)
        loss.backward()
    if mesh is None or mesh.size == 1:
        p = tlm.as_ranks(ps)[0]
        return loss.item(), met, {n: t.grad.numpy()
                                  for n, t in p.named_parameters()}
    return loss.item(), met, _global_grads(ps, cfg, mesh)


@pytest.mark.parametrize("case", LOSS_CASES,
                         ids=lambda c: case_id(*c).replace("/", "-"))
def test_loss_and_every_grad_match_jax(jx, case):
    """The port's loss, aux loss and every gradient leaf on the data
    mesh against JAX's on the same mesh (or, where JAX's step raises,
    against JAX's one-device step), and against the port's one rank."""
    arch, mesh, mode, rows = case
    cfg = _cfg(arch)
    c = case_id(*case)
    tree = _tree(jx, f"p/{arch}/")
    batch = _batch(cfg, rows)
    loss, met, grads = _port_loss(cfg, tree, _mesh(*mesh), mode, batch)
    loss1, met1, g1 = _port_loss(cfg, tree, None, mode, batch)
    where = "mesh" if f"{c}/mesh/loss" in jx else "one"
    if where == "one":
        print(f"JAX {c}: its data-mesh step raised; held to its one device")
    np.testing.assert_allclose(loss, float(jx[f"{c}/{where}/loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(loss, loss1, rtol=1e-5)
    np.testing.assert_allclose(met["aux"].item(), float(jx[f"{c}/{where}/"
                                                           f"aux"]),
                               rtol=1e-5, atol=1e-7)
    assert set(grads) == set(g1)
    for n, g in grads.items():
        want = jx[f"{c}/{where}/g/{n}"]
        gap = np.abs(want - jx[f"{c}/one/g/{n}"]).max()
        if arch in F64_ARCHS:
            exact = jx[f"f64/{arch}/g/{n}"]
            gap = np.abs(want - exact).max()
            want = exact
        _leaf_close(g, want, 1e-3, f"{n} vs JAX", extra=gap)
        _leaf_close(g, g1[n], 1e-3, f"{n} vs (1, 1)")


def test_rwkv6_at_float64_equals_jax_at_float64(jx, monkeypatch):
    """rwkv6-smoke with every float32 and bf16 cast lifted to float64 in
    both packages (:func:`lifted_casts`; the port's ``Tensor.float``
    too), the port on the (2, 1) mesh against JAX on one device: the
    loss within 1e-12 relative and every gradient leaf within 1e-9 of
    its largest |entry|. The two compute one function, so their float32
    gaps on this batch are float32's (ROADMAP queue 3)."""
    arch = "rwkv6-3b"
    cfg = _cfg(arch).replace(dtype=torch.float64)
    m = _mesh(2, 1)
    one = params_from_numpy(_tree(jx, f"p/{arch}/"), cfg, device="cpu",
                            trainable=True).double()
    ps = tlm.shard_params(one, m)
    monkeypatch.setattr(torch.Tensor, "float",
                        lambda self, *a, **k: self.double())
    with lifted_casts("repro_torch", torch, ("float32", "bfloat16"),
                      torch.float64), use(DistContext(m, "ring")):
        loss, _ = tlm.loss_fn(ps, shard_batch(train_batch(cfg, 4), "cpu",
                                              m), cfg)
        loss.backward()
    assert loss.dtype == torch.float64
    np.testing.assert_allclose(loss.item(), float(jx[f"f64/{arch}/loss"]),
                               rtol=1e-12)
    for n, g in _global_grads(ps, cfg, m).items():
        _leaf_close(g, jx[f"f64/{arch}/g/{n}"], 1e-9, n)


def test_moe_aux_is_the_global_batch_s(jx):
    """olmoe at (2, 1): the aux loss is E sum(me fe) of the global
    batch's means (one rank's aux), which a mean of the two groups'
    own products would not be."""
    from repro_torch.models import moe
    cfg = _cfg("olmoe-1b-7b")
    tree = _tree(jx, "p/olmoe-1b-7b/")
    batch = _batch(cfg, 4)
    _, met1, _ = _port_loss(cfg, tree, None, "ring", batch)
    _, met, _ = _port_loss(cfg, tree, _mesh(2, 1), "ring", batch)
    np.testing.assert_allclose(met["aux"].item(), met1["aux"].item(),
                               rtol=1e-6)
    p = params_from_numpy(tree, cfg, device="cpu")
    halves = []
    for g in range(2):
        rows = {k: v[2 * g:2 * g + 2] for k, v in batch.items()}
        with torch.no_grad():
            halves.append(tlm.loss_fn(p, rows, cfg)[1]["aux"].item())
    assert abs(np.mean(halves) - met1["aux"].item()) > 1e-4
    assert moe.switch_aux(torch.ones(4) / 4, torch.ones(4) / 4).item() == 1


def test_a_batch_that_does_not_divide_is_replicated():
    """2 rows over 4 data groups: every group runs both rows (JAX's
    fallback), and the loss and gradients equal the one-rank run's, not
    4 times them."""
    cfg = _cfg()
    p = tlm.init_params(cfg, seed=4, device="cpu", trainable=True)
    tree = {k: v.detach().numpy() for k, v in tree_items(tlm.param_tree(p))}
    tree = _nest(tree)
    batch = _batch(cfg, 2)
    loss, _, grads = _port_loss(cfg, tree, _mesh(4, 1), "ring", batch)
    loss1, _, g1 = _port_loss(cfg, tree, None, "ring", batch)
    np.testing.assert_allclose(loss, loss1, rtol=1e-6)
    for n, g in grads.items():
        _leaf_close(g, g1[n], 1e-5, n)
    groups = shard_batch({k: v.numpy() for k, v in batch.items()}, "cpu",
                         _mesh(4, 1))
    assert len(groups) == 4 and all(torch.equal(g["tokens"], batch["tokens"])
                                    for g in groups)
    groups = shard_batch({k: v.numpy() for k, v in _batch(cfg, 4).items()},
                         "cpu", _mesh(2, 2))
    assert [tuple(g["tokens"].shape) for g in groups] == [(2, SEQ)] * 2


def test_group_batches_equal_the_global_batch():
    """``shard_batch`` over a data mesh gives each group its block of
    JAX's ``batch_sharding``: the groups' rows joined are the global
    batch, bit for bit; ``loss_fn`` on a data mesh refuses a batch that
    is not one a group, naming ``shard_batch``."""
    cfg = _cfg()
    m = _mesh(2, 2)
    b = train_batch(cfg, 4)
    groups = shard_batch(b, "cpu", m)
    bs = tsteps.batch_sharding(tsr.rules_for(cfg, m),
                               {k: _t(v) for k, v in b.items()})
    for k, v in b.items():
        assert bs[k]["data_dim"] == 0
        assert torch.equal(torch.cat([g[k] for g in groups]), _t(v))
    ps = tlm.init_params(cfg, seed=2, device="cpu", mesh=m)
    with use(DistContext(m, "ring")), torch.no_grad(), \
            pytest.raises(TypeError, match="shard_batch"):
        tlm.loss_fn(ps, {k: _t(v) for k, v in b.items()}, cfg)


def test_two_adamw_steps_match_jax(jx):
    tree = _tree(jx, "p/llama3-8b/")
    mesh = _mesh(*ADAM_MESH)
    ps, opt, ms = _two_steps(tree, mesh)
    p1, _, one = _two_steps(tree, None)
    for i, (m, m1) in enumerate(zip(ms, one)):
        lt, gt = (1e-5, 1e-3) if i == 0 else (1e-3, 2e-2)
        np.testing.assert_allclose(m["loss"], m1["loss"], rtol=lt)
        np.testing.assert_allclose(m["grad_norm"], m1["grad_norm"], rtol=gt)
        np.testing.assert_allclose(m["loss"], float(jx[f"adam/loss{i}"]),
                                   rtol=lt)
        np.testing.assert_allclose(m["grad_norm"],
                                   float(jx[f"adam/gnorm{i}"]), rtol=gt)
    want = dict(tree_items(_tree(jx, "adam/p/")))
    init = dict(tree_items(tree))
    got = tlm.gather_params(ps, mesh)
    w1 = dict(p1.named_parameters())
    for n, t in got.named_parameters():
        t, t1 = t.detach().numpy(), w1[n].detach().numpy()
        moved = np.linalg.norm(t1 - init[n])
        assert moved > 0, n
        for ref, what in ((t1, "(1, 1)"), (want[n], "JAX")):
            rel = np.linalg.norm(t - ref) / moved
            diff = np.abs(t - ref).max()
            assert rel <= 0.3 and diff <= 4 * 2 * LR, \
                f"{n}: {rel:.3e} of the update, max {diff:.3e} vs {what}"
    # the copies of each block stay bit-identical
    specs = tlm.leaf_specs(_cfg(), mesh)
    trees = [dict(p.named_parameters()) for p in ps]
    ms_ = [dict(tree_items(o["m"])) for o in opt]
    for n, s in specs.items():
        for r in range(1, mesh.size):
            if _block(s, mesh.coords(r), mesh) == _block(s, mesh.coords(0),
                                                         mesh):
                assert torch.equal(trees[r][n], trees[0][n]), n
                assert torch.equal(ms_[r][n], ms_[0][n]), n


# ------------------------------------------------------------- dry run
def test_dry_run_traces_one_data_group_with_its_fsdp_gathers():
    """The dry run on a data mesh traces one data group: at (data 2,
    model 2) a rank's parameter bytes are the rules' shards and its
    matmul FLOPs those of a model-only tp 2 step on its half of the
    batch (FSDP adds copies, not products); at (data 2, model 4) the
    role's 4 ranks each gather every FSDP leaf over the 2 data ranks,
    each layer's twice (the remat recomputes it), and each gather's
    gradient is reduce-scattered once."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    cfg = smoke_config(get_config("llama3-8b"))
    rec = dryrun.run_cell_cfg(cfg, ShapeConfig("t", 32, 4, "train"), 2,
                              data=2)
    half = dryrun.run_cell_cfg(cfg, ShapeConfig("t", 32, 2, "train"), 2)
    assert rec["status"] == "ok" and rec["mesh"] == "2dx2m"
    assert rec["chips"] == 4
    psh = _flat(tsteps.param_shardings(cfg, tsr.rules_for(cfg, _mesh(2, 2))))
    assert rec["memory"]["param_bytes"] == 4 * sum(
        int(np.prod(v["shape"])) for v in psh.values())
    assert rec["cost"]["flops"] == half["cost"]["flops"]
    cfg = cfg.replace(remat=True)
    t = dryrun.trace(cfg, ShapeConfig("t", 32, 4, "train"), 4, data=2)
    dims = tlm.data_dims(cfg, _mesh(2, 4))
    top = sum(1 for k, d in dims.items()
              if d is not None and not k.startswith("backbone"))
    layer = sum(1 for k, d in dims.items()
                if d is not None and k.startswith("backbone"))
    fsdp_ops = [(op, g) for op, _, g in t["events"] if g == 2]
    assert fsdp_ops.count(("all-gather", 2)) == \
        4 * (top + 2 * layer * cfg.n_layers)
    assert fsdp_ops.count(("reduce-scatter", 2)) == \
        4 * (top + layer * cfg.n_layers)
