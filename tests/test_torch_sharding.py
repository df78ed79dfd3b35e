"""The port's sharding plane (``repro_torch.utils.sharding``, the ParamDef
plans' logical axes, the ``ModelAPI`` sharding methods) against the JAX
package's on the CPU.

Specs are compared as tuples (``tuple(P)``): the port's ``PartitionSpec``
is a tuple of mesh-axis names. JAX meshes are built as
``tests/test_sharding.py`` builds them (the one CPU device repeated); the
port's are ``MeshShape``s of the same names and sizes, or, where
placements need a process group, a ``fake`` group of 8 ranks destroyed in
a ``finally``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import INPUT_SHAPES as JAX_SHAPES  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.registry import build_model as jax_build  # noqa: E402
from repro.utils import sharding as JS  # noqa: E402
from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.utils import sharding as TS  # noqa: E402

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _jax_mesh(shape, axes):
    devs = np.array(jax.devices() * int(np.prod(shape)))[: int(np.prod(shape))]
    return Mesh(devs.reshape(shape), axes)


def _meshes(name):
    shape, axes = MESHES[name]
    return _jax_mesh(shape, axes), TS.MeshShape(axes, shape)


def _leaves(tree, path=()):
    """(path, leaf) of a nested dict, keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], path + (k,))]
    return [(path, tree)]


def _same_tree(got, want, leaf_eq):
    g, w = _leaves(got), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert leaf_eq(a, b), (path, a, b)


def _spec_eq(a, b):
    return tuple(a) == tuple(b)


def _def_eq(a, b):
    return (tuple(a.shape) == tuple(b.shape) and a.spec == b.spec
            and a.init == b.init and a.std == b.std)


# ------------------------------------------------------------ resolve_spec
@pytest.mark.parametrize("logical,shape,mesh", [
    (("vocab", "embed"), (64_000, 512), "2x4"),
    (("vocab", "embed"), (51_865, 512), "2x4"),
    (("embed", "heads", "head_dim"), (896, 14, 64), "2x4"),
    (("embed", "heads", "head_dim"), (896, 16, 64), "2x4"),
    (("batch", None), (16, 128), "2x2x2"),
    (("batch", None), (1, 128), "2x2x2"),
])
def test_resolve_spec_matches_jax_cases(logical, shape, mesh):
    """The cases of ``tests/test_sharding.py``."""
    if mesh == "2x2x2":
        jm = _jax_mesh((2, 2, 2), ("pod", "data", "model"))
        tm = TS.MeshShape(("pod", "data", "model"), (2, 2, 2))
    else:
        jm, tm = _meshes(mesh)
    want = JS.resolve_spec(logical, shape, jm)
    got = TS.resolve_spec(logical, shape, tm)
    assert tuple(got) == tuple(want)
    assert isinstance(got, TS.PartitionSpec)


NAMES = st.sampled_from(sorted(k for k in TS.DEFAULT_RULES if k) + [None])


@settings(max_examples=60, deadline=None)
@given(dims=st.lists(st.integers(1, 4096), min_size=1, max_size=4),
       names=st.lists(NAMES, min_size=1, max_size=4),
       data=st.sampled_from([1, 2, 4, 16]),
       model=st.sampled_from([1, 2, 4, 8, 16]),
       pod=st.sampled_from([0, 2]))
def test_property_resolve_spec_matches_jax(dims, names, data, model, pod):
    shape, axes = (data, model), ("data", "model")
    if pod:
        shape, axes = (pod,) + shape, ("pod",) + axes
    jm = _jax_mesh(shape, axes)
    tm = TS.MeshShape(axes, shape)
    logical = tuple(names[:len(dims)])
    assert tuple(TS.resolve_spec(logical, dims, tm)) == \
        tuple(JS.resolve_spec(logical, dims, jm))
    assert TS.batch_axes(tm) == JS.batch_axes(jm)


# ------------------------------------------------------------------- plans
ARCH_NAMES = sorted(ARCHS)


def _pair(name, reduced):
    cfg, jcfg = get_config(name), JAX_ARCHS[name]
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    return build_model(cfg, device="cpu"), jax_build(jcfg)


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_plans_equal_jax_leaf_for_leaf(name, reduced):
    """``plan``, ``cache_plan`` and ``paged_cache_plan``: every leaf's
    (shape, spec, init, std)."""
    api, japi = _pair(name, reduced)
    _same_tree(api.plan, japi.plan, _def_eq)
    _same_tree(api.cache_plan(3, 64), japi.cache_plan(3, 64), _def_eq)
    assert (api.paged_cache_plan is None) == (japi.paged_cache_plan is None)
    if api.paged_cache_plan is not None:
        _same_tree(api.paged_cache_plan(3, 9, 16, 4),
                   japi.paged_cache_plan(3, 9, 16, 4), _def_eq)


def test_stack_plan_prepends_the_stack_axis():
    plan = {"w": TL.ParamDef((4, 8), ("embed", "mlp")),
            "b": TL.ParamDef((8,), None, "zeros")}
    got = TL.stack_plan(plan, 3)
    assert got["w"] == TL.ParamDef((3, 4, 8), ("stack", "embed", "mlp"))
    assert got["b"] == TL.ParamDef((3, 8), ("stack", None), "zeros")
    jgot = JL.stack_plan({"b": JL.ParamDef((8,), None, "zeros")}, 3)
    assert jgot["b"].spec == got["b"].spec


# ---------------------------------------------------------------- ModelAPI
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_model_api_specs_equal_jax(name, mesh):
    """``param_specs``, ``cache_specs`` and ``input_shardings`` of the
    full-width configs at every input shape."""
    api, japi = _pair(name, False)
    jm, tm = _meshes(mesh)
    _same_tree(api.param_specs(tm), japi.param_specs(jm), _spec_eq)
    for batch, clen in ((128, 32_768), (1, 8_192), (32, 4_096)):
        _same_tree(api.cache_specs(tm, batch, clen),
                   japi.cache_specs(jm, batch, clen), _spec_eq)
    for shape in INPUT_SHAPES.values():
        got = api.input_shardings(shape, tm)
        want = japi.input_shardings(JAX_SHAPES[shape.name], jm)
        _same_tree(got, want, _spec_eq)


def _dtype_eq(t, sds):
    return (tuple(t.shape) == tuple(sds.shape)
            and str(t.dtype).replace("torch.", "") == str(sds.dtype))


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_abstract_trees_and_input_specs_equal_jax(name):
    api, japi = _pair(name, False)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        _same_tree(api.abstract_params(dt), japi.abstract_params(jdt),
                   _dtype_eq)
    _same_tree(api.abstract_cache(128, 2048), japi.abstract_cache(128, 2048),
               _dtype_eq)
    for shape in INPUT_SHAPES.values():
        _same_tree(api.input_specs(shape),
                   japi.input_specs(JAX_SHAPES[shape.name]), _dtype_eq)
    leaf = _leaves(api.abstract_params())[0][1]
    assert leaf.device.type == "meta"


def test_input_shapes_equal_jax():
    assert list(INPUT_SHAPES) == list(JAX_SHAPES)
    for k, s in INPUT_SHAPES.items():
        j = JAX_SHAPES[k]
        assert (s.name, s.seq_len, s.global_batch, s.kind) == \
            (j.name, j.seq_len, j.global_batch, j.kind)


# -------------------------------------------------------------- placements
@pytest.fixture
def fake_group_8():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("logical,shape", [
    (("batch", None, "heads", None), (8, 16, 4, 8)),
    (("embed", "mlp"), (12, 32)),
    (("vocab", "embed"), (6, 4)),           # 6 rows do not split 4 ways
    (("batch", "kv_seq", None, None), (4, 64, 2, 8)),
])
def test_local_shard_has_the_shape_the_spec_implies(fake_group_8, logical,
                                                    shape):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    spec = TS.resolve_spec(logical, shape, mesh)
    assert tuple(spec) == tuple(TS.resolve_spec(
        logical, shape, TS.MeshShape(("data", "model"), (2, 4))))
    x = distribute_tensor(torch.zeros(shape), mesh, TS.placements(spec, mesh))
    assert tuple(x.to_local().shape) == TS.local_shape(shape, spec, mesh)
    assert tuple(x.shape) == shape


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    m = TS.MeshShape(("pod", "data", "model"), (2, 2, 4))
    assert TS.placements(TS.P(("pod", "data"), None, "model"), m) == (
        Shard(0), Shard(0), Shard(2))
    assert TS.placements(TS.P(), m) == (Replicate(),) * 3
    one = TS.MeshShape(("data", "model"), (1, 1))
    assert TS.placements(TS.P("data", "model"), one) == (Replicate(),) * 2


def test_maybe_constrain_is_the_identity_off_a_mesh():
    x = torch.arange(6.0).reshape(2, 3)
    assert TS.active_mesh() is None
    assert TS.maybe_constrain(x, "batch", None) is x
    with TS.use_mesh(TS.MeshShape(("data", "model"), (2, 4))) as m:
        assert TS.active_mesh() is m
        # a plain tensor is the single-card path: unchanged under a mesh
        assert TS.maybe_constrain(x, "batch", None) is x
    assert TS.active_mesh() is None


# ------------------------------------------------------------------ engine
def test_engine_with_a_1x1_mesh_streams_like_without(fake_group_8):
    """``InferenceEngine(mesh=)`` keeps the parameters' placements and
    nothing else: a 1×1 mesh and no mesh give the same greedy streams on
    olmo-1b reduced."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate
    from repro_torch.serving.engine import InferenceEngine
    cfg = get_config("olmo-1b").reduced()
    api = build_model(cfg, device="cpu")
    params = api.init(torch.Generator().manual_seed(0))
    mesh = DeviceMesh("cpu", torch.zeros((1, 1), dtype=torch.int64),
                      mesh_dim_names=("data", "model"))
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)))
    streams = []
    for m in (None, mesh):
        eng = InferenceEngine(api, params, cache_len=64, mesh=m)
        assert eng.mesh is m
        streams.append(eng.generate({"tokens": tokens}, 6).numpy())
    placed = eng._param_sh
    assert set(_leaves(placed)[0][1]) == {Replicate()}
    np.testing.assert_array_equal(streams[0], streams[1])
