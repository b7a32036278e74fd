"""The port's configs, shape grid and roofline formulas against the JAX
package's, on the CPU (all pure Python on both sides).

For every one of the 10 architectures and its smoke config, at each of
the four shapes: ``applicable``, the ``cells`` list, ``n_params``,
``n_active_params``, ``q_per_kv``, ``subquadratic``,
``is_attention_free``, ``hd_rwkv``, ``model_flops_for`` and
``analytic_memory_bytes`` at 1, 8 and 256 chips equal JAX's exactly;
``wire_bytes`` equals JAX's ``collective_bytes`` on one HLO line per op
kind at group sizes 2, 4 and 8.
"""
import pytest

pytest.importorskip("torch")

from repro import configs as jcfg  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.roofline import analysis as jan  # noqa: E402
from repro_torch import configs as pcfg  # noqa: E402
from repro_torch.configs import shapes as pshapes  # noqa: E402
from repro_torch.roofline import analysis as pan  # noqa: E402
from repro_torch.roofline import hw  # noqa: E402

ARCHS = [(a, smoke) for a in jshapes.ARCH_IDS for smoke in (False, True)]


def _cfgs(arch, smoke):
    j, p = jcfg.get_config(arch), pcfg.get_config(arch)
    if smoke:
        j, p = jcfg.smoke_config(j), pcfg.smoke_config(p)
    return j, p


def test_grid_equals_jax():
    assert pshapes.ARCH_IDS == jshapes.ARCH_IDS
    assert [(s.name, s.seq_len, s.global_batch, s.kind)
            for s in pcfg.ALL_SHAPES] == [
        (s.name, s.seq_len, s.global_batch, s.kind)
        for s in jcfg.ALL_SHAPES]
    cp = [(a, s.name, ok, why) for a, s, ok, why in pshapes.cells()]
    cj = [(a, s.name, ok, why) for a, s, ok, why in jshapes.cells()]
    assert cp == cj and len(cp) == 40
    for s in jcfg.ALL_SHAPES:
        assert pcfg.get_shape(s.name).is_decode == s.is_decode
    with pytest.raises(KeyError):
        pcfg.get_shape("nope")


@pytest.mark.parametrize("arch,smoke", ARCHS)
def test_sizes_and_roofline_formulas_equal_jax(arch, smoke):
    j, p = _cfgs(arch, smoke)
    for name in ("q_per_kv", "is_attention_free", "subquadratic",
                 "has_decode", "hd"):
        assert getattr(p, name) == getattr(j, name), name
    for name in ("n_params", "n_active_params", "hd_rwkv"):
        assert getattr(p, name)() == getattr(j, name)(), name
    for sj in jcfg.ALL_SHAPES:
        sp = pcfg.get_shape(sj.name)
        assert pshapes.applicable(p, sp) == jshapes.applicable(j, sj)
        assert pan.model_flops_for(p, sp) == jan.model_flops_for(j, sj)
        for chips in (1, 8, 256):
            assert pan.analytic_memory_bytes(p, sp, chips) == \
                jan.analytic_memory_bytes(j, sj, chips)


HLO = {
    "all-gather": "%ag = bf16[8,1024,4096]{2,1,0} all-gather(bf16[8,1024,"
                  "512]{2,1,0} %x), replica_groups={G}, dimensions={2}",
    "reduce-scatter": "%rs = f32[8,128,4096]{2,1,0} reduce-scatter(f32[8,"
                      "1024,4096]{2,1,0} %x), replica_groups={G}, "
                      "dimensions={1}, to_apply=%add",
    "all-reduce": "%ar = f32[16,4096]{1,0} all-reduce(f32[16,4096]{1,0} "
                  "%x), replica_groups={G}, to_apply=%add",
    "all-to-all": "%a2a = bf16[64,320,2048]{2,1,0} all-to-all(bf16[64,320,"
                  "2048]{2,1,0} %x), replica_groups={G}, dimensions={0}",
    "collective-permute": "%cp = bf16[2,256,4096]{2,1,0} collective-permute("
                          "bf16[2,256,4096]{2,1,0} %x), source_target_pairs"
                          "={{0,1},{1,0}}, replica_groups={G}",
}


@pytest.mark.parametrize("op", sorted(HLO))
@pytest.mark.parametrize("group", (2, 4, 8))
def test_wire_bytes_equal_jax_ring_factors(op, group):
    ids = "{" + ",".join(str(i) for i in range(group)) + "}"
    line = HLO[op].replace("{G}", "{" + ids + "}")
    st = jan.collective_bytes(line)
    assert st.counts == {op: 1}
    size = jan._line_operand_bytes(line)
    assert pan.wire_bytes(op, size, group) == st.wire_bytes_per_chip
    ours = pan.collective_stats([(op, size, group)])
    assert ours.counts == st.counts
    assert ours.wire_bytes_per_chip == st.wire_bytes_per_chip


def test_roofline_uses_its_chip_and_dtype():
    """roofline_fraction at the peak of the chip and dtype it was given;
    dominant_star/frac_star on the analytic memory term."""
    coll = pan.CollectiveStats({}, 0.0, [])
    kw = dict(arch="a", shape_name="s", mesh_desc="1m", chips=2,
              flops=989e12, bytes_=3.35e12 * 4, coll=coll,
              model_flops=989e12, analytic_bytes=3.35e12 * 0.5)
    r = pan.analyze(**kw)
    assert r.compute_s == 1.0 and r.memory_s == 4.0
    assert r.dominant == "memory" and r.bound_s == 4.0
    assert r.dominant_star == "compute" and r.bound_s_star == 1.0
    assert r.roofline_fraction == pytest.approx(0.5 / 4.0)
    assert r.frac_star == pytest.approx(0.5)
    assert r.useful_fraction == pytest.approx(0.5)
    r32 = pan.analyze(**kw, dtype="fp32")
    assert r32.compute_s == pytest.approx(989e12 / 67e12)
    assert r32.roofline_fraction == pytest.approx(
        989e12 / (2 * 67e12) / r32.bound_s)
    slow = hw.Chip(name="half", peak_bf16_flops=989e12 / 2)
    assert pan.analyze(**kw, chip=slow).compute_s == 2.0
    d = r.to_json()
    assert d["chip"] == "h100-sxm" and d["frac_star"] == r.frac_star
