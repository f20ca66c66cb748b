"""The port's WAN layer against the JAX reference and its golden fixture,
on the CPU.

`repro_torch.geo.{topology, placement}` are held to their `repro` twins.
The great-circle math, link states and profiles (numpy's ``default_rng``),
static edge weights and the static shortest-path matrix must be equal to
the reference's and match ``tests/golden/geo/region_graph.npz`` within
that file's tolerance.  The port draws its link overlays from a
`torch.Generator`, so the time-varying matrices are compared with the
reference's overlays copied in, and the port's own overlays are held to
the metric invariants.  `regional_arrivals` draws from a generator and is
checked by its signature.
"""
import dataclasses
import itertools
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.core import latency as jlatency
from repro.geo import placement as jplacement
from repro.geo import topology as jtopology
from repro_torch.chaos import PartitionFault
from repro_torch.core import latency
from repro_torch.geo import placement, topology

CPU = "cpu"
GRAPH_NPZ = pathlib.Path(__file__).parent / "golden" / "geo" / "region_graph.npz"
GOLDEN_RTOL, GOLDEN_ATOL = 1e-4, 1e-2          # tests/test_golden_geo.py's


def _pair(n_regions, seed, **kw):
    """The reference topology and the port's, the port holding the
    reference's link overlays."""
    ref = jtopology.build_topology(n_regions, seed=seed, **kw)
    mine = topology.build_topology(n_regions, seed=seed, device=CPU, **kw)
    mine._overlays = ref._overlays
    mine._rtt_cache.clear()
    return mine, ref


def test_catalog_distances_and_constants_equal_reference():
    assert topology.REGION_CATALOG == tuple(
        topology.Region(*dataclasses.astuple(r)) for r in jtopology.REGION_CATALOG)
    assert (topology.FIBER_KM_PER_MS, topology.ROUTE_INFLATION, topology.HOP_OVERHEAD_MS,
            topology.LINK_STATES) == (jtopology.FIBER_KM_PER_MS, jtopology.ROUTE_INFLATION,
                                      jtopology.HOP_OVERHEAD_MS, jtopology.LINK_STATES)
    for a, b in itertools.product(range(8), repeat=2):
        d = topology.great_circle_km(topology.REGION_CATALOG[a], topology.REGION_CATALOG[b])
        jd = jtopology.great_circle_km(jtopology.REGION_CATALOG[a], jtopology.REGION_CATALOG[b])
        assert d == jd
        assert topology.propagation_rtt_ms(d) == jtopology.propagation_rtt_ms(jd)


@pytest.mark.parametrize("n_regions,seed", [(2, 0), (4, 1), (6, 2024), (8, 7)])
def test_links_and_static_matrices_equal_reference(n_regions, seed):
    kw = dict(horizon_s=600.0, dt_s=10.0)
    mine = topology.build_topology(n_regions, seed=seed, device=CPU, **kw)
    ref = jtopology.build_topology(n_regions, seed=seed, **kw)
    assert [(ln.a, ln.b, ln.base_rtt_ms, ln.state) for ln in mine.links] == [
        (ln.a, ln.b, ln.base_rtt_ms, ln.state) for ln in ref.links]
    assert latency.pack_profiles([ln.profile for ln in mine.links]).tobytes() == \
        jlatency.pack_profiles([ln.profile for ln in ref.links]).tobytes()
    np.testing.assert_array_equal(mine.edge_weights(None), ref.edge_weights(None))
    np.testing.assert_array_equal(mine.rtt_matrix(None), ref.rtt_matrix(None))
    assert mine.n_steps == ref.n_steps == 60 and mine._overlays.shape == (len(mine.links), 60)
    for r in range(n_regions):
        assert mine.tz_phase(r) == ref.tz_phase(r)
    states = ["ideal", "outage"]
    a = topology.build_topology(n_regions, seed=seed, link_states=states, rtt_scale=0.5,
                                device=CPU, **kw)
    b = jtopology.build_topology(n_regions, seed=seed, link_states=states, rtt_scale=0.5, **kw)
    np.testing.assert_array_equal(a.rtt_matrix(None), b.rtt_matrix(None))


def test_static_matrices_match_golden_fixture():
    """The values `tests/test_golden_geo.py` freezes that do not depend on
    the overlay stream, within that file's tolerance."""
    stored = np.load(GRAPH_NPZ)
    topo = topology.build_topology(6, seed=2024, horizon_s=2400.0, dt_s=10.0, device=CPU)
    fresh = {
        "rtt_static": topo.rtt_matrix(None),
        "edge_weights_static": topo.edge_weights(None),
        "link_base_rtt": np.asarray([ln.base_rtt_ms for ln in topo.links], np.float32),
    }
    for name, got in fresh.items():
        np.testing.assert_allclose(got, stored[name], rtol=GOLDEN_RTOL, atol=GOLDEN_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("n_regions,scale", [(3, 1.0), (6, 3.0)])
def test_rtt_matrix_per_tick_with_reference_overlays(n_regions, scale):
    mine, ref = _pair(n_regions, 11, horizon_s=1800.0, dt_s=10.0, rtt_scale=scale)
    for t in (-4, 0, 1, 57, 90, 179, 500):
        np.testing.assert_array_equal(mine.edge_weights(t), ref.edge_weights(t))
        got = mine.rtt_matrix(t)
        np.testing.assert_array_equal(got, ref.rtt_matrix(t))
        assert not got.flags.writeable and mine.rtt_matrix(t) is got      # cached per tick
    path = list(range(n_regions)) + [0]
    assert mine.path_rtt_ms(path, 33) == ref.path_rtt_ms(path, 33)
    assert mine.path_rtt_ms(path) == ref.path_rtt_ms(path)


def test_own_overlays_keep_the_metric_invariants(monkeypatch):
    topo = topology.build_topology(6, seed=3, horizon_s=3600.0, dt_s=10.0, device=CPU)
    again = topology.build_topology(6, seed=3, horizon_s=3600.0, dt_s=10.0, device=CPU)
    np.testing.assert_array_equal(topo._overlays, again._overlays)
    assert topo._overlays.dtype == np.float32 and (topo._overlays >= 1.0).all()
    for t in (None, 0, 100, 359):
        m = topo.rtt_matrix(t).astype(np.float64)
        np.testing.assert_allclose(m, m.T)
        assert (np.diag(m) == 0.0).all() and (m >= 0.0).all()
        assert (m[:, :, None] <= m[:, None, :] + m.T[None, :, :] + 1e-3).all()  # triangle
    zero = topology.build_topology(4, seed=3, horizon_s=600.0, rtt_scale=0.0, device=CPU)
    assert (zero.rtt_matrix(30) == 0.0).all()
    with pytest.raises(ValueError):
        topology.build_topology(1, device=CPU)
    with pytest.raises(ValueError):
        topology.WanTopology(topo.regions[:3], [topo.links[0]], device=CPU)   # disconnected
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        topology.build_topology(3, seed=99, horizon_s=600.0)


def test_placement_helpers_equal_reference():
    for n, R, seed, skew in ((12, 3, 0, 0.0), (100, 6, 2, 1.0), (7, 4, 1, 2.5), (3, 5, 0, 1.2)):
        np.testing.assert_array_equal(placement.place_servers(n, R, seed, skew),
                                      jplacement.place_servers(n, R, seed, skew))
    for R, skew in ((1, 0.0), (4, 0.0), (6, 1.0), (8, -1.0)):
        a, b = placement.client_populations(R, skew), jplacement.client_populations(R, skew)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    mine, ref = _pair(4, 5, horizon_s=900.0, dt_s=10.0)
    srv = jplacement.place_servers(30, 4, skew=1.0)
    gp = placement.GeoPlacement(mine, srv, placement.client_populations(4, 1.5))
    jgp = jplacement.GeoPlacement(ref, srv, jplacement.client_populations(4, 1.5))
    assert (gp.n_servers, gp.n_regions) == (jgp.n_servers, jgp.n_regions)
    for t in (None, 0, 45, 89):
        np.testing.assert_array_equal(gp.region_server_rtt(t), jgp.region_server_rtt(t))
        for r in range(4):
            np.testing.assert_array_equal(gp.client_rtt_ms(r, t), jgp.client_rtt_ms(r, t))
    for r in range(4):
        assert gp.region_servers(r) == jgp.region_servers(r)
        f, jf = gp.regional_partition(r, 60.0, 120.0), jgp.regional_partition(r, 60.0, 120.0)
        assert isinstance(f, PartitionFault)
        assert dataclasses.asdict(f) == dataclasses.asdict(jf)
    uniform = placement.GeoPlacement(mine, srv)
    np.testing.assert_array_equal(uniform.client_weights,
                                  jplacement.GeoPlacement(ref, srv).client_weights)
    with pytest.raises(ValueError):
        placement.GeoPlacement(mine, np.asarray([0, 4]))
    with pytest.raises(ValueError):
        placement.GeoPlacement(mine, srv, np.ones(3, np.float32))


def test_regional_arrivals_signature():
    """Sorted f64 times on [0, horizon), i32 region tags in range, counts per
    region near the integral of its diurnal rate (rate x weight, phase from
    its timezone), deterministic per generator seed,
    nothing from a zero-weight region; the reference's stream meets the
    same bounds."""
    topo = topology.build_topology(3, seed=0, horizon_s=600.0, dt_s=1.0, device=CPU)
    w = np.asarray([0.6, 0.4, 0.0], np.float32)
    gp = placement.GeoPlacement(topo, placement.place_servers(6, 3), w)
    g = lambda s: torch.Generator(device=CPU).manual_seed(s)
    rate, horizon = 20.0, 400.0
    t, r = placement.regional_arrivals(g(1), gp, rate, horizon)
    t2, r2 = placement.regional_arrivals(g(1), gp, rate, horizon)
    np.testing.assert_array_equal(t, t2)
    np.testing.assert_array_equal(r, r2)
    assert not np.array_equal(t[:20], placement.regional_arrivals(g(2), gp, rate, horizon)[0][:20])
    jgp = jplacement.GeoPlacement(jtopology.build_topology(3, seed=0, horizon_s=600.0, dt_s=1.0),
                                  jplacement.place_servers(6, 3), w)
    jt, jr = jplacement.regional_arrivals(jax.random.PRNGKey(1), jgp, rate, horizon)
    for times, tags in ((t, r), (jt, jr)):
        assert times.dtype == np.float64 and tags.dtype == np.int32
        assert (np.diff(times) >= 0.0).all() and times.min() >= 0.0 and times.max() < horizon
        assert set(np.unique(tags)) == {0, 1}
        for reg in (0, 1):
            ph, period = topo.tz_phase(reg), 24 * 3600.0
            swing = (np.cos(ph) - np.cos(2 * np.pi * horizon / period + ph)) * period / (2 * np.pi)
            want = rate * w[reg] * (horizon + 0.6 * swing)
            assert abs((tags == reg).sum() - want) < 5.0 * np.sqrt(want)
    empty = placement.GeoPlacement(topo, placement.place_servers(6, 3), np.zeros(3, np.float32))
    et, er = placement.regional_arrivals(g(1), empty, rate, horizon)
    assert et.shape == er.shape == (0,)
