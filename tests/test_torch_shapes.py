"""The dry run's model surface in the port against the JAX package: the
assigned shape table, ``input_specs``, ``abstract_params``, ``param_axes``
(every assigned arch at full size, on the ``meta`` device: nothing is
allocated) and the sharding rules' resolution on the JAX package's meshes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import _flatten, params_from_numpy  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

ARCHS = jconfigs.assigned_archs()
MESHES = [((2, 2), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
MODES = ["train", "prefill", "decode", "long_decode"]


def _configs(arch):
    """(the JAX config, the port's) at full size."""
    jcfg = jconfigs.get_config(arch)
    return jcfg, tconfigs.ModelConfig.from_json(jcfg.to_json())


def _flat_axes(tree, prefix="", out=None):
    """Dotted names as bridge._flatten gives them, axis tuples as leaves."""
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat_axes(v, f"{prefix}{k}.", out)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            _flat_axes(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = tree
    return out


def _flat(tree):
    out = {}
    _flatten(tree, "", out)
    return out


def _dtype_name(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def _spec(p) -> tuple:
    """A JAX PartitionSpec as the port's tuple of entries."""
    return tuple(tsh.UNCONSTRAINED if e is P.UNCONSTRAINED else e for e in p)


def test_shape_table_and_assigned_archs():
    assert tconfigs.assigned_archs() == jconfigs.assigned_archs()
    assert list(tconfigs.SHAPES) == list(jconfigs.SHAPES)
    for name, s in jconfigs.SHAPES.items():
        t = tconfigs.SHAPES[name]
        assert (t.name, t.seq_len, t.global_batch, t.mode) == \
            (s.name, s.seq_len, s.global_batch, s.mode)
    for name in ("TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K"):
        assert getattr(tconfigs, name) == tconfigs.SHAPES[getattr(jconfigs, name).name]


@pytest.mark.parametrize("name", jconfigs.list_configs())
def test_applicable_shapes(name):
    jcfg, tcfg = _configs(name)
    assert tconfigs.applicable_shapes(tcfg) == jconfigs.applicable_shapes(jcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs(arch):
    jcfg, tcfg = _configs(arch)
    jm = jax_build(jcfg)
    for sname, reason in jconfigs.applicable_shapes(jcfg).items():
        if reason is not None:
            continue
        jspecs, jaxes = jm.input_specs(jconfigs.SHAPES[sname])
        tspecs, taxes = tt.input_specs(tcfg, tconfigs.SHAPES[sname])
        assert list(tspecs) == list(jspecs) and taxes == jaxes, (arch, sname)
        for k, s in jspecs.items():
            t = tspecs[k]
            assert t.device.type == "meta", (arch, sname, k)
            assert tuple(t.shape) == s.shape and _dtype_name(t) == str(s.dtype), (arch, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_axes(arch):
    jcfg, tcfg = _configs(arch)
    jm = jax_build(jcfg)
    jabs, tabs = _flat(jm.abstract_params()), _flat(tt.abstract_params(tcfg))
    assert sorted(tabs) == sorted(jabs)           # jax.tree.map sorts a dict's keys
    for name, s in jabs.items():
        t = tabs[name]
        assert t.device.type == "meta", name           # no storage: nothing allocated
        assert tuple(t.shape) == s.shape and _dtype_name(t) == str(s.dtype), name
    assert _flat_axes(tt.param_axes(tcfg)) == _flat_axes(jm.param_axes())


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_name_the_state_dict(arch):
    """At a reduced size the abstract tree, flattened, names and shapes the
    built model's state_dict; the LM's methods give the module functions'."""
    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    lm = LM(tconfigs.ModelConfig.from_json(jcfg.to_json()), device="cpu")
    flat = _flat(lm.abstract_params())
    sd = lm.state_dict()
    assert list(flat) == list(sd)
    for name, t in sd.items():
        assert flat[name].shape == t.shape and flat[name].dtype == t.dtype, name
    assert lm.param_axes() == tt.param_axes(lm.cfg)
    shape = tconfigs.TRAIN_4K
    assert lm.input_specs(shape)[1] == tt.input_specs(lm.cfg, shape)[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_carries_every_parameter(arch):
    """The JAX params tree, bridged by its dotted paths, loads into the port
    whole (patch_proj and unembed included) and bit for bit."""
    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    params = jax.tree.map(np.asarray, jax_build(jcfg).init_params(jax.random.PRNGKey(2)))
    lm = LM(tconfigs.ModelConfig.from_json(jcfg.to_json()), device="cpu")
    lm.load_state_dict(params_from_numpy(params))
    for name, t in lm.state_dict().items():
        want = _flat(params)[name]
        got = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
        np.testing.assert_array_equal(got, want.view(np.int16) if want.dtype.name == "bfloat16"
                                      else want, err_msg=name)


@pytest.mark.parametrize("mode", MODES)
def test_rule_tables_keep_their_order(mode):
    """Order is priority: the tables' keys in the JAX order, with equal rules."""
    j, t = jsh.RULES_BY_MODE[mode], tsh.RULES_BY_MODE[mode]
    assert list(t) == list(j)
    assert {k: [tuple(c) for c in v] for k, v in t.items()} == \
        {k: [tuple(c) for c in v] for k, v in j.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_resolve_spec_of_every_parameter(arch):
    """Every parameter of the full-size arch, on every mesh, under every mode's
    rules and ``rules_for_cfg``'s, concrete and for a constraint."""
    jcfg, tcfg = _configs(arch)
    jm = jax_build(jcfg)
    shapes = _flat(jm.abstract_params())
    axes = _flat_axes(jm.param_axes())
    for sizes, names in MESHES:
        jmesh, tmesh = AbstractMesh(sizes, names), tsh.MeshShape(sizes, names)
        for mode in MODES:
            tables = [(jsh.RULES_BY_MODE[mode], tsh.RULES_BY_MODE[mode]),
                      (jsh.rules_for_cfg(mode, jcfg), tsh.rules_for_cfg(mode, tcfg))]
            for jrules, trules in tables:
                for name, s in shapes.items():
                    for fc in (False, True):
                        want = jsh.resolve_spec(jmesh, s.shape, axes[name], jrules,
                                                for_constraint=fc)
                        got = tsh.resolve_spec(tmesh, s.shape, axes[name], trules,
                                               for_constraint=fc)
                        assert got == _spec(want), (arch, sizes, mode, name, fc)


@pytest.mark.parametrize("arch", ARCHS)
def test_resolve_spec_of_the_inputs(arch):
    """The activation axes of ``input_specs`` at every applicable shape, on
    every mesh, under that shape's mode's rules, concrete and for a
    constraint (where a failed rule leaves the dim UNCONSTRAINED)."""
    jcfg, tcfg = _configs(arch)
    jm = jax_build(jcfg)
    for sname, reason in jconfigs.applicable_shapes(jcfg).items():
        if reason is not None:
            continue
        shape = jconfigs.SHAPES[sname]
        jspecs, jaxes = jm.input_specs(shape)
        for sizes, names in MESHES:
            jmesh, tmesh = AbstractMesh(sizes, names), tsh.MeshShape(sizes, names)
            jrules = jsh.rules_for_cfg(shape.mode, jcfg)
            trules = tsh.rules_for_cfg(shape.mode, tcfg)
            for k, s in jspecs.items():
                for fc in (False, True):
                    want = jsh.resolve_spec(jmesh, s.shape, jaxes[k], jrules, for_constraint=fc)
                    got = tsh.resolve_spec(tmesh, s.shape, jaxes[k], trules, for_constraint=fc)
                    assert got == _spec(want), (arch, sname, sizes, k, fc)


@pytest.mark.parametrize("shape,names,fc", [
    ((32, 4096, 56, 128), ("act_batch", "act_seq", "act_heads", None), True),
    ((32, 4096, 56, 128), ("act_batch", "act_seq", "act_heads", None), False),
    ((48, 128, 32768, 16, 128), ("w_layers", "act_batch", "act_kv_seq", "act_kv_heads", None),
     False),
    ((64, 128, 32768, 8, 128), ("w_layers", "act_batch", "act_kv_seq", "act_kv_heads", None),
     True),
    ((9, 1, 524288, 8, 128), ("w_layers", "act_batch", "act_kv_seq", "act_kv_heads", None),
     False),
])
@pytest.mark.parametrize("mode", MODES)
def test_resolve_spec_of_activations(shape, names, fc, mode):
    """The JAX tests' activation cases (56 heads, kv 16 and 8, a 500k cache)
    under every mode on every mesh."""
    for sizes, axis_names in MESHES:
        want = jsh.resolve_spec(AbstractMesh(sizes, axis_names), shape, names,
                                jsh.RULES_BY_MODE[mode], for_constraint=fc)
        got = tsh.resolve_spec(tsh.MeshShape(sizes, axis_names), shape, names,
                               tsh.RULES_BY_MODE[mode], for_constraint=fc)
        assert got == _spec(want), (sizes, mode)


def test_unconstrained_and_trimming():
    mesh = tsh.MeshShape((16, 16), ("data", "model"))
    names = ("act_batch", "act_seq", "act_heads", None)
    spec = tsh.resolve_spec(mesh, (32, 4096, 56, 128), names, tsh.TRAIN_RULES,
                            for_constraint=True)
    assert spec == ("data", None, tsh.UNCONSTRAINED, None)
    assert tsh.resolve_spec(mesh, (32, 4096, 56, 128), names, tsh.TRAIN_RULES) == ("data",)
    with pytest.raises(ValueError):
        tsh.resolve_spec(mesh, (32, 4096), names, tsh.TRAIN_RULES)


NAME_POOL = ["act_batch", "act_seq", "act_kv_seq", "act_kv_heads", "act_heads", "act_mlp",
             "act_vocab", "act_embed", "w_embed", "w_qdim", "w_kvdim", "w_mlp", "w_expert",
             "w_moe_mlp", "w_layers", None]


def test_resolve_spec_equals_jax_on_drawn_axes():
    """Drawn (logical name, dim) lists, as tests/test_property.py draws them,
    resolve as the JAX package resolves them: every mode, every mesh, concrete
    and for a constraint."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @given(st.lists(st.tuples(st.sampled_from(NAME_POOL),
                              st.sampled_from([1, 2, 8, 16, 56, 64, 128, 504, 4096])),
                    min_size=1, max_size=5))
    @settings(max_examples=200, deadline=None, database=None)
    def check(dims_names):
        names = tuple(n for n, _ in dims_names)
        shape = tuple(d for _, d in dims_names)
        for sizes, axis_names in MESHES:
            jmesh = AbstractMesh(sizes, axis_names)
            tmesh = tsh.MeshShape(sizes, axis_names)
            for mode in MODES:
                for fc in (False, True):
                    want = jsh.resolve_spec(jmesh, shape, names, jsh.RULES_BY_MODE[mode],
                                            for_constraint=fc)
                    got = tsh.resolve_spec(tmesh, shape, names, tsh.RULES_BY_MODE[mode],
                                           for_constraint=fc)
                    assert got == _spec(want), (shape, names, sizes, mode, fc)

    check()
