"""The port's logical-axis sharding (`repro_torch.dist.sharding`), meshes
and the shardings the dry run prices (`launch/steps.py`, `models/api.py`
specs), held against the JAX package's: rule resolution over drawn names,
rule sets and meshes; per leaf of the train state, for every arch at full
width under every rule set on both production meshes; the per-device
argument bytes; the decode-state and batch specs."""
import math

import jax
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st_

from repro.configs import RunConfig as JRunConfig
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.dist import sharding as jsh
from repro.launch import steps as jsteps
from repro.models import api as japi

from repro_torch.configs import ARCH_IDS, SHAPES, RunConfig, get_config
from repro_torch.dist import sharding as sh
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps
from repro_torch.models import api
from repro_torch.tree import flatten

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
_NAMES = sorted({n for r in sh.RULE_SETS.values() for n in r}
                | {"seq", "kv_seq", "layers", "nope"})


def _path(entries) -> str:
    out = []
    for e in entries:
        for attr in ("key", "name", "idx"):
            if hasattr(e, attr):
                out.append(str(getattr(e, attr)))
                break
    return "/".join(out)


def _ref_flat(tree):
    """(path, leaf) of a reference pytree, as `repro_torch.tree.flatten`
    names them; a NamedTuple's fields by name."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple) and x != ()
        and all(a is None or isinstance(a, str) for a in x))
    return sorted((_path(p), x) for p, x in leaves)


def _port_flat(tree):
    if isinstance(tree, steps.TrainState):
        tree = tree._asdict()
    return sorted((p, x) for p, x in flatten(tree) if x != ())


@pytest.fixture(scope="module")
def ref_specs():
    """The reference's parameter shapes and axes, one eval_shape a
    config (its `train_state_shardings` would trace them three times a
    call)."""
    cache = {}
    shapes_of, axes_of = japi.param_shapes, japi.param_axes

    def get(cfg):
        if cfg not in cache:
            cache[cfg] = (shapes_of(cfg), axes_of(cfg))
        return cache[cfg]
    return get


@pytest.fixture
def cached_ref(monkeypatch, ref_specs):
    monkeypatch.setattr(japi, "param_shapes", lambda cfg: ref_specs(cfg)[0])
    monkeypatch.setattr(japi, "param_axes", lambda cfg: ref_specs(cfg)[1])


_entries = st_.one_of(st_.none(), st_.sampled_from(_NAMES))
_meshes = st_.sampled_from([(("data", "model"), 2), (("pod", "data", "model"), 3),
                            (("model",), 1), (("data",), 1)]).flatmap(
    lambda m: st_.tuples(st_.just(m[0]),
                         st_.lists(st_.integers(1, 8), min_size=m[1],
                                   max_size=m[1])))


@given(names=st_.lists(_entries, min_size=0, max_size=5),
       rules=st_.sampled_from(sorted(sh.RULE_SETS)), mesh=_meshes,
       dims=st_.lists(st_.integers(1, 64), min_size=5, max_size=5))
@settings(max_examples=150, deadline=None)
def test_resolution_matches_the_reference(names, rules, mesh, dims):
    axes, sizes = mesh
    jm = jsh.abstract_mesh(tuple(sizes), axes)
    pm = sh.abstract_mesh(tuple(sizes), axes)
    shape = tuple(dims[:len(names)])
    jr, pr = jsh.RULE_SETS[rules], sh.RULE_SETS[rules]
    assert tuple(sh.logical_spec(names, pr, pm)) == \
        tuple(jsh.logical_spec(names, jr, jm))
    assert tuple(sh.spec(names, pr, pm)) == tuple(jsh.spec(names, jr, jm))
    got = sh.spec(names, pr, pm, shape)
    want = jsh.spec(names, jr, jm, shape)
    assert tuple(got) == tuple(want)
    ljs = jsh.logical_spec(names, jr, jm)
    assert tuple(sh.divisible_spec(pm, sh.logical_spec(names, pr, pm),
                                   shape)) == \
        tuple(jsh.divisible_spec(jm, ljs, shape))
    assert sh.NamedSharding(pm, got).shard_shape(shape) == \
        jax.sharding.NamedSharding(jm, want).shard_shape(shape)


def test_rule_sets_and_meshes_are_the_references():
    assert sh.RULE_SETS == jsh.RULE_SETS
    for multi, (sizes, axes) in zip((False, True), MESHES.values()):
        m = mesh_mod.make_production_mesh(multi_pod=multi)
        assert (m.axis_sizes, m.axis_names, m.size) == \
            (sizes, axes, math.prod(sizes))
    host = mesh_mod.make_host_mesh(4, 2)
    n = max(1, torch.cuda.device_count())
    assert host.axis_names == ("data", "model") and host.size <= n
    assert mesh_mod.make_mesh((2, 4), ("a", "b")).shape == {"a": 2, "b": 4}


def test_constrain_resolves_inside_a_context_and_returns_x():
    x = torch.zeros(4, 6)
    assert sh.constrain(x, "batch", "bogus", "third") is x   # no context
    with sh.use_sharding(sh.abstract_mesh((2, 3), ("data", "model")),
                         sh.MEGATRON_RULES):
        assert sh.current_sharding()[1] is sh.MEGATRON_RULES
        assert sh.constrain(x, "batch", "heads") is x
        with pytest.raises(ValueError):
            sh.constrain(x, "batch", "heads", "ff")   # longer than the rank
    assert sh.current_sharding() is None
    with pytest.raises(ValueError):
        sh.NamedSharding(sh.abstract_mesh((2,), ("data",)),
                         sh.PartitionSpec("model"))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_state_shardings_match_the_reference(arch, cached_ref):
    """Per leaf of the train state (params, AdamW's m and v under ZeRO-1,
    the step) and of the batch, for every rule set on both production
    meshes: the port's specs and shard shapes equal the reference's, and
    its per-device argument bytes equal the reference's shards summed."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    p_axes = api.param_axes(cfg)
    assert _port_flat(p_axes) == _ref_flat(japi.param_axes(jcfg))
    p_shapes = _port_flat(api.param_shapes(cfg))
    assert [(p, tuple(t.shape), str(t.dtype)[6:]) for p, t in p_shapes] == \
        [(p, tuple(s.shape), str(s.dtype))
         for p, s in _ref_flat(japi.param_shapes(jcfg))]
    state = steps.train_state_specs(cfg, RunConfig())
    jstate = jsteps.train_state_specs(jcfg, JRunConfig())
    shape = SHAPES["train_4k"]
    for mesh_name, (sizes, axes) in MESHES.items():
        pm = sh.abstract_mesh(sizes, axes)
        jm = jsh.abstract_mesh(sizes, axes)
        for rules in sorted(sh.RULE_SETS):
            got = steps.train_state_shardings(pm, cfg, RunConfig(),
                                              sh.RULE_SETS[rules])
            want = jsteps.train_state_shardings(jm, jcfg, JRunConfig(),
                                                jsh.RULE_SETS[rules])
            g, w = _port_flat(got), _ref_flat(want)
            assert [p for p, _ in g] == [p for p, _ in w]
            for (path, gs), (_, ws), (_, t), (_, js) in zip(
                    g, w, _port_flat(state), _ref_flat(jstate)):
                assert tuple(gs.spec) == tuple(ws.spec), \
                    (mesh_name, rules, path)
                assert gs.shard_shape(tuple(t.shape)) == \
                    ws.shard_shape(js.shape), (mesh_name, rules, path)
            # the dry run's per-device argument bytes: state and batch
            want_bytes = 0
            b_sh, b_specs = jsteps.batch_shardings(
                jm, jcfg, JSHAPES["train_4k"], jsh.RULE_SETS[rules])
            for tree_sh, tree in ((want, jstate), (b_sh, b_specs)):
                for (_, s), (_, x) in zip(_ref_flat(tree_sh),
                                          _ref_flat(tree)):
                    want_bytes += (math.prod(s.shard_shape(x.shape))
                                   * jnp.dtype(x.dtype).itemsize)
            _, meta = dryrun.count_cell(arch, shape, pm,
                                        sh.RULE_SETS[rules], counts={})
            assert meta["argument_bytes"] == want_bytes, (mesh_name, rules)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_state_and_batch_specs_match_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    vals, axes = api.decode_state_specs(cfg, 4, 16)
    jvals, jaxes = japi.decode_state_specs(jcfg, 4, 16)
    assert _port_flat(axes) == _ref_flat(jaxes)
    assert [(p, tuple(t.shape), str(t.dtype)[6:], t.device.type)
            for p, t in _port_flat(vals)] == \
        [(p, tuple(s.shape), str(s.dtype), "meta")
         for p, s in _ref_flat(jvals)]
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        for fn, jfn in ((api.batch_specs, japi.batch_specs),
                        (api.decode_batch_specs, japi.decode_batch_specs)):
            specs, b_axes = fn(cfg, SHAPES[name])
            jspecs, jb_axes = jfn(jcfg, JSHAPES[name])
            assert b_axes == jb_axes
            assert {k: (tuple(t.shape), str(t.dtype)[6:])
                    for k, t in specs.items()} == \
                {k: (tuple(s.shape), str(s.dtype))
                 for k, s in jspecs.items()}


def test_make_batch_has_the_references_keys_shapes_and_ranges():
    for arch in ("qwen3-1.7b", "qwen2-vl-2b", "hubert-xlarge"):
        cfg, jcfg = get_config(arch, smoke=True), jget_config(arch,
                                                              smoke=True)
        shape = SHAPES["train_4k"]
        got = api.make_batch(cfg, shape, torch.Generator().manual_seed(1),
                             batch_override=2, seq_override=8)
        want = japi.make_batch(jcfg, JSHAPES["train_4k"],
                               jax.random.PRNGKey(1), batch_override=2,
                               seq_override=8)
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
        for k, v in got.items():
            if not v.is_floating_point():
                assert 0 <= int(v.min()) and int(v.max()) < max(
                    cfg.vocab_size, 8)
        if "positions" in got:
            assert torch.equal(got["positions"][1, 1], torch.arange(8))


def test_make_batch_without_a_generator_runs_on_the_card_unless_asked(
        monkeypatch):
    """Like `init`, `make_batch` with no generator draws on the card and
    refuses the CPU unless the caller names it."""
    from repro_torch.device import NoCudaDevice
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, shape = get_config("qwen3-1.7b", smoke=True), SHAPES["train_4k"]
    with pytest.raises(NoCudaDevice, match="device='cpu'"):
        api.make_batch(cfg, shape, batch_override=2, seq_override=8)
    got = api.make_batch(cfg, shape, batch_override=2, seq_override=8,
                         device="cpu")
    assert got["tokens"].device.type == "cpu"
    assert torch.equal(got["tokens"], api.make_batch(
        cfg, shape, torch.Generator().manual_seed(0), batch_override=2,
        seq_override=8)["tokens"])
