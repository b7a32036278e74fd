"""The port's training loop against the JAX package's on the CPU: AdamW
and the LR schedule, the data pipeline and the tokenizer, and the
trainer's CLI, checkpoints and resume.

Tolerances, with their reasons:
* AdamW, three steps: parameters, ``m`` and ``v`` within 1e-6 of each
  leaf's largest |entry|, grad norm and lr within 1e-6 relative (the
  same float32 ops; a reduction, ``pow`` and ``sqrt`` may round one ulp
  apart, and ``b * m + (1 - b) * g`` may cancel to far below the size
  of its terms);
* the schedule: 1e-6 relative (float32 ``cos``);
* data and tokenizer: byte-equal;
* the trainer resuming a JAX checkpoint: losses of the resumed steps
  within 2e-3 relative of JAX's uninterrupted run (the smoke config
  computes in bf16; the state it resumes from is JAX's, exactly);
* the port's own resume: bit-equal losses and parameters (the CPU runs
  the same ops in the same order).
"""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import pipeline as jdata  # noqa: E402
from repro.data import tokenizer as jtok  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedule as jsched  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.data import tokenizer as ttok  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.module import tree_items, tree_map  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import schedule as tsched  # noqa: E402

torch.set_num_threads(2)


# ------------------------------------------------------------ optimizer
def _tree(r, shapes):
    return {k: _tree(r, v) if isinstance(v, dict)
            else r.normal(size=v).astype(np.float32)
            for k, v in shapes.items()}


SHAPES = {"backbone": {"layers": {"mlp": {"wu": (2, 6, 5), "wd": (2, 5, 6)},
                                  "ln1": {"scale": (2, 6)}}},
          "embed": {"table": (9, 6)}, "head": {"table": (9, 6)}}


@pytest.mark.parametrize("lr", ["cosine", 3e-3])
def test_adamw_three_steps_match_jax(lr):
    r = np.random.default_rng(0)
    params = _tree(r, SHAPES)
    grads = [tree_map(lambda _, x: x * 10 ** s, _tree(r, SHAPES))
             for s in (-1, 0, 1)]       # the last step is clipped
    kw = dict(lr=jsched.warmup_cosine(1e-2, 2, 3) if lr == "cosine" else lr)
    jcfg = jadamw.AdamWConfig(**kw)
    tcfg = tadamw.AdamWConfig(lr=tsched.warmup_cosine(1e-2, 2, 3)
                              if lr == "cosine" else lr)
    jp = jax.tree.map(jnp.asarray, params)
    js = jadamw.init_state(jp)
    tp = tree_map(lambda _, x: torch.from_numpy(x.copy()), params)
    ts = tadamw.init_state(tp)
    for g in grads:
        jp, js, jm = jadamw.apply_updates(jp, jax.tree.map(jnp.asarray, g),
                                          js, jcfg)
        tm = tadamw.apply_updates(tp, tree_map(
            lambda _, x: torch.from_numpy(x), g), ts, tcfg)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(tm["lr"].item(), float(jm["lr"]),
                                   rtol=1e-6)
        for mine, theirs in ((tp, jp), (ts["m"], js["m"]),
                             (ts["v"], js["v"])):
            want = dict(tree_items(jax.tree.map(np.asarray, theirs)))
            for name, t in tree_items(mine):
                np.testing.assert_allclose(
                    t.numpy(), want[name], err_msg=name, rtol=0,
                    atol=1e-6 * np.abs(want[name]).max())
        assert int(ts["step"]) == int(js["step"])
    assert ts["step"].dtype == torch.int32


def test_no_decay_is_a_substring_test_on_the_jax_path():
    """``backbone/layers/mlp/wu`` contains ``"u"``: JAX gives it no
    weight decay, and neither does the port; ``wd`` decays."""
    r = np.random.default_rng(1)
    params = _tree(r, SHAPES)
    zeros = tree_map(lambda _, x: np.zeros_like(x), params)
    cfg = tadamw.AdamWConfig(lr=0.1)
    tp = tree_map(lambda _, x: torch.from_numpy(x.copy()), params)
    tadamw.apply_updates(tp, tree_map(lambda _, x: torch.from_numpy(x),
                                      zeros), tadamw.init_state(tp), cfg)
    jp, _, _ = jadamw.apply_updates(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, zeros),
        jadamw.init_state(jax.tree.map(jnp.asarray, params)),
        jadamw.AdamWConfig(lr=0.1))
    mlp, jmlp = tp["backbone"]["layers"]["mlp"], jp["backbone"]["layers"]["mlp"]
    orig = params["backbone"]["layers"]["mlp"]
    for got in (mlp["wu"].numpy(), np.asarray(jmlp["wu"])):
        np.testing.assert_array_equal(got, orig["wu"])
    for got in (mlp["wd"].numpy(), np.asarray(jmlp["wd"])):
        np.testing.assert_allclose(got, orig["wd"] * (1 - 0.1 * 0.1),
                                   rtol=1e-6)


@pytest.mark.parametrize("peak,warmup,total", [(3e-4, 20, 100),
                                               (1e-3, 6, 6), (1.0, 0, 10)])
def test_warmup_cosine_and_constant_match_jax(peak, warmup, total):
    steps = np.arange(0, total + 5, dtype=np.int32)
    want = np.asarray(jax.vmap(jsched.warmup_cosine(peak, warmup, total))(
        jnp.asarray(steps)))
    f = tsched.warmup_cosine(peak, warmup, total)
    got = np.array([f(torch.tensor(s)).item() for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    c = tsched.constant(peak)(torch.tensor(3, dtype=torch.int32))
    assert c.dtype == torch.float32
    assert c.item() == float(jsched.constant(peak)(jnp.int32(3)))


# ----------------------------------------------------------------- data
def test_synthetic_lm_batches_are_byte_equal():
    for seed, host, hosts in ((0, 0, 1), (3, 1, 2)):
        kw = dict(vocab_size=512, seq_len=24, global_batch=4, seed=seed,
                  host_id=host, n_hosts=hosts)
        j, t = jdata.SyntheticLM(**kw), tdata.SyntheticLM(**kw)
        for step in (0, 1, 17):
            jb, tb = j.batch_at(step), t.batch_at(step)
            for k in ("tokens", "labels"):
                assert jb[k].dtype == tb[k].dtype
                np.testing.assert_array_equal(jb[k], tb[k])


def test_byte_corpus_and_tokenizer_are_byte_equal(tmp_path):
    text = "The port trains as JAX does. été ✓\n" * 20
    path = tmp_path / "corpus.txt"
    path.write_text(text, encoding="utf-8")
    j = jdata.ByteCorpus(str(path), seq_len=16, global_batch=3, seed=2)
    t = tdata.ByteCorpus(str(path), seq_len=16, global_batch=3, seed=2)
    for step in (0, 5):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(j.batch_at(step)[k],
                                          t.batch_at(step)[k])
    for bos, eos in ((True, False), (False, True)):
        ids = ttok.encode(text, add_bos=bos, add_eos=eos)
        assert ids == jtok.encode(text, add_bos=bos, add_eos=eos)
        assert ttok.decode(ids) == jtok.decode(ids) == text
    assert (ttok.PAD, ttok.BOS, ttok.EOS, ttok.VOCAB_SIZE) == \
        (jtok.PAD, jtok.BOS, jtok.EOS, jtok.VOCAB_SIZE)
    sb = tdata.shard_batch(t.batch_at(0), "cpu")
    assert sb["tokens"].dtype == torch.int32


# -------------------------------------------------------------- trainer
RUN = ["--arch", "llama3-8b", "--smoke", "--batch", "2", "--seq", "16",
       "--log-every", "1"]


def _step_dir(src, step, dst):
    """A checkpoint directory holding only step ``step`` of ``src``."""
    os.makedirs(dst)
    name = f"step_{step:08d}"
    shutil.copytree(os.path.join(src, name), os.path.join(dst, name))
    return str(dst)


def test_port_resumes_a_jax_checkpoint_and_continues_its_curve(tmp_path):
    """JAX trains 4 steps, checkpointing every 2 (step 2 is what a 2-step
    run leaves: warmup 20 > steps, so the lr schedule does not depend on
    the total); the port resumes step 2's checkpoint (``params%%...``,
    ``opt%%m%%...``, ``opt%%step``) on the CPU and runs steps 2 and 3 on
    the same data: their losses follow JAX's run."""
    jdir = str(tmp_path / "jax")
    jlog = jtrain.main(RUN + ["--steps", "4", "--ckpt-dir", jdir,
                              "--ckpt-every", "2"])
    assert [m["step"] for m in jlog] == [0, 1, 2, 3]
    pdir = _step_dir(jdir, 2, tmp_path / "port")
    plog = ttrain.main(RUN + ["--steps", "4", "--ckpt-dir", pdir,
                              "--resume", "--device", "cpu"])
    assert [m["step"] for m in plog] == [2, 3]
    np.testing.assert_allclose([m["loss"] for m in plog],
                               [m["loss"] for m in jlog[2:]], rtol=2e-3)
    # the port's checkpoint of step 4 has JAX's keys, dtypes and shapes
    flat, manifest = Checkpointer(pdir).read()
    with np.load(os.path.join(jdir, "step_00000004", "shard_0.npz")) as z:
        assert set(flat) == set(z.files)
        for k in z.files:
            assert tuple(flat[k].shape) == z[k].shape, k
            assert str(flat[k].dtype).split(".")[-1] == str(z[k].dtype), k
    assert manifest["extra"]["next_step"] == 4


def test_port_resume_equals_the_uninterrupted_run(tmp_path):
    full = ttrain.parse_args(RUN + ["--steps", "4", "--device", "cpu",
                                    "--ckpt-dir", str(tmp_path / "a"),
                                    "--ckpt-every", "2"])
    from repro_torch.configs import get_config, smoke_config
    cfg = smoke_config(get_config("llama3-8b"))
    want = ttrain.train(cfg, full)
    bdir = _step_dir(tmp_path / "a", 2, tmp_path / "b")
    got = ttrain.train(cfg, ttrain.parse_args(
        RUN + ["--steps", "4", "--device", "cpu", "--ckpt-dir", bdir,
               "--resume"]))
    assert got["start_step"] == 2
    assert [m["loss"] for m in got["log"]] == \
        [m["loss"] for m in want["log"][2:]]
    for (n, p), (_, q) in zip(got["params"].named_parameters(),
                              want["params"].named_parameters()):
        assert torch.equal(p, q), n
    assert int(got["opt"]["step"]) == int(want["opt"]["step"]) == 4


def test_trainer_refuses_what_it_cannot_run():
    with pytest.raises(NotImplementedError, match="10b"):
        ttrain.main(RUN + ["--steps", "1", "--device", "cpu", "--tp", "2"])
    with pytest.raises(NotImplementedError, match="one rank"):
        ttrain.main(RUN + ["--steps", "1", "--device", "cpu", "--mesh",
                           "production"])
    if torch.cuda.is_available():
        pytest.skip("the default device is present here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(RUN + ["--steps", "1"])
