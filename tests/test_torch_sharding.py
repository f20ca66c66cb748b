"""The port's sharding rules and logical meshes (`repro_torch.nn.sharding`,
`repro_torch.launch.mesh`) against the JAX reference, on the CPU.

`logical_to_spec` resolves each tensor's spec from its logical axis names;
the port's must equal the reference's, drops included, for every layout and
every parameter and cache tensor of the ten full configs, on the
production meshes' shapes (16 x 16 and 2 x 16 x 16, as the reference's
`FakeMesh`: the rules read only axis names and sizes).  The reference's
hand cases and its divisibility property run against the port's function.
This file imports `repro.nn.sharding`, never `repro.launch.dryrun` (which
writes `os.environ` when imported).
"""
import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import configs as jconfigs
from repro.models.api import get_model as jget_model
from repro.nn import sharding as jsharding
from repro_torch import configs, tree
from repro_torch.launch import mesh as meshlib
from repro_torch.models.api import get_model
from repro_torch.nn.core import is_axes
from repro_torch.nn.sharding import LAYOUTS, P, LayoutReport, logical_to_spec, tree_shardings


class FakeMesh:
    def __init__(self, sizes: dict):
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()))


MESH = FakeMesh({"data": 16, "model": 16})
MESHES = {"16x16": MESH, "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16})}


def _reference_specs(axes, shapes, mesh, rules):
    """The reference's specs of a tree, leaf by leaf in `jax.tree` order,
    and its drop report (as its `tree_shardings` notes them)."""
    rep = jsharding.LayoutReport()
    names = jax.tree.leaves(axes, is_leaf=is_axes)
    arrays = jax.tree.leaves(shapes)
    specs = [tuple(jsharding.logical_to_spec(n, a.shape, mesh, rules, rep))
             for n, a in zip(names, arrays)]
    return specs, rep.dropped


def _port_specs(axes, tensors, mesh, rules):
    rep = LayoutReport()
    shard = tree_shardings(axes, tensors, mesh, rules, rep)
    return [tuple(s.spec) for s in tree.leaves(shard)], rep.dropped


def test_layouts_equal_reference_key_for_key():
    assert list(LAYOUTS) == list(jsharding.LAYOUTS)
    for name, fn in LAYOUTS.items():
        assert fn() == jsharding.LAYOUTS[name](), name


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_specs_and_drops_equal_reference_for_every_layout(arch):
    """Every layout x both production meshes: the parameters' and the
    decode_32k (long_500k for the subquadratic archs) cache's specs and
    drop reports equal the reference's."""
    jmodel = jget_model(jconfigs.get_config(arch))
    jparams, jaxes = jmodel.init_params(jax.random.PRNGKey(0), abstract=True)
    model = get_model(configs.get_config(arch))
    params, axes = model.init_params(abstract=True), model.param_axes()
    shapes = [("decode_32k", 128, 32768)]
    if arch in configs.SUBQUADRATIC:
        shapes.append(("long_500k", 1, 524288))
    caches = [(jmodel.init_cache(B, S, abstract=True), model.init_cache(B, S, device="meta"))
              for _, B, S in shapes]
    n_drops = 0
    for mesh_name, mesh in MESHES.items():
        for layout, fn in LAYOUTS.items():
            rules = fn()
            want = _reference_specs(jaxes, jparams, mesh, jsharding.LAYOUTS[layout]())
            got = _port_specs(axes, params, mesh, rules)
            assert got == want, (mesh_name, layout)
            n_drops += len(got[1])
            for jcache, cache in caches:
                want = _reference_specs(jmodel.cache_axes(), jcache, mesh,
                                        jsharding.LAYOUTS[layout]())
                got = _port_specs(model.cache_axes(), cache, mesh, rules)
                assert got == want, (mesh_name, layout, "cache")
                n_drops += len(got[1])
    assert len(tree.leaves(params)) == len(jax.tree.leaves(jparams))
    if arch in ("internvl2-1b", "whisper-tiny"):    # 2 / 6 kv heads: fallbacks happen
        assert n_drops > 0


def test_batch_specs_name_the_dropped_tensor():
    for mesh in MESHES.values():
        for layout in LAYOUTS:
            for names, shape in ((("batch", "seq"), (1, 524288)), (("batch", None), (128, 1)),
                                 (("batch", "frames", "embed"), (32, 1500, 384))):
                rep, jrep = LayoutReport(), jsharding.LayoutReport()
                got = logical_to_spec(names, shape, mesh, LAYOUTS[layout](), rep, "tokens")
                want = jsharding.logical_to_spec(names, shape, mesh,
                                                 jsharding.LAYOUTS[layout](), jrep, "tokens")
                assert tuple(got) == tuple(want) and rep.dropped == jrep.dropped


# the reference's hand cases (tests/test_sharding.py), against the port

def test_basic_mapping():
    spec = logical_to_spec(("batch", "seq"), (256, 4096), MESH, {"batch": ("data",), "seq": None})
    assert spec == P("data", None)


def test_divisibility_fallback_drops_axis():
    rep = LayoutReport()
    spec = logical_to_spec(
        ("heads", "head_dim"), (14, 64), MESH, {"heads": ("model",), "head_dim": None},
        report=rep,
    )
    assert spec == P(None, None)
    assert rep.dropped and rep.dropped[0][3] == 14


def test_single_use_invariant():
    spec = logical_to_spec(
        ("batch", "embed"), (256, 4096), MESH,
        {"batch": ("data",), "embed": ("data",)},
    )
    assert spec == P("data", None)  # second use of "data" dropped


def test_tuple_axes_partial_fallback():
    mesh = FakeMesh({"pod": 2, "data": 16, "model": 16})
    spec = logical_to_spec(("batch",), (16,), mesh, {"batch": ("pod", "data")})
    # 16 % (2*16) != 0 -> drop trailing "data", keep "pod"
    assert spec == P("pod")


def test_missing_mesh_axis_ignored():
    spec = logical_to_spec(("batch",), (64,), MESH, {"batch": ("pod", "data")})
    assert spec == P("data")


@settings(max_examples=50, deadline=None)
@given(
    dim=st.integers(1, 4096),
    axes=st.sampled_from([("data",), ("model",), ("data", "model"), None]),
)
def test_spec_always_divides(dim, axes):
    spec = logical_to_spec(("x",), (dim,), MESH, {"x": axes})
    assert tuple(spec) == tuple(jsharding.logical_to_spec(("x",), (dim,), MESH, {"x": axes}))
    sizes = {"data": 16, "model": 16}
    entry = spec[0]
    if entry is not None:
        names = entry if isinstance(entry, tuple) else (entry,)
        total = int(np.prod([sizes[a] for a in names]))
        assert dim % total == 0


def test_production_and_debug_meshes_read_like_the_fake_mesh():
    for multi_pod, shape in ((False, {"data": 16, "model": 16}),
                             (True, {"pod": 2, "data": 16, "model": 16})):
        mesh = meshlib.make_production_mesh(multi_pod=multi_pod)
        assert dict(zip(mesh.axis_names, mesh.devices.shape)) == shape
        assert meshlib.mesh_chips(mesh) == 256 * (1 + multi_pod)
        fake = FakeMesh(shape)
        for layout in LAYOUTS:
            for names, dims in ((("batch", "seq"), (256, 4096)), (("embed_fsdp", "qkv"),
                                                                  (896, 896))):
                assert logical_to_spec(names, dims, mesh, LAYOUTS[layout]()) == \
                    logical_to_spec(names, dims, fake, LAYOUTS[layout]())
    dbg = meshlib.make_debug_mesh(2, 4)
    assert dbg.axis_names == ("data", "model") and dbg.devices.shape == (2, 4)
    assert meshlib.mesh_chips(dbg) == 8


def test_fleet_mesh_needs_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="fleet mesh needs 2 devices, have 0"):
        meshlib.make_fleet_mesh(2)
