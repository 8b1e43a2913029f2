"""The rest of the port's GeoWrapper API against the JAX package's: the 13
setters, Streamer.close and the memory report.

- Each setter on both packages' GeoWrappers, built from the same
  constructor arguments: after every call the config fields the two
  MapConfigs share and the 13 getters are equal; both raise ValueError
  with the same message for a hash bucket size or a linked-list length
  other than the compile-time one; both clamp a weight cap above 255 with
  the same message.
- A rebuild between frames: 3 frames, setVirtualVoxelSize, 3 more frames
  of a 64x256 relief, on poses without translation (jitted XLA contracts
  `voxel * vvs - t` into an FMA otherwise, PORT_NOTES.md P4); per block
  key the maps are equal within tests/test_torch_pipeline.py's bounds
  (weight and rgbp exact, sdf within 2e-5, sumsq within 5e-4), before the
  rebuild and after it.
- ROADMAP C16: after setSdfTruncation the reference integrates with its
  old truncation; the port's map equals that of a JAX GeoWrapper built
  with the new truncation that took over the plain wrapper's state.
- Streamer.close joins an asynchronous stream-out in flight (its blocks
  are in the grid afterwards), re-raises the job's error, and stops the
  worker: after 10 rebuilds, each with a stream-out in flight, no thread
  is left.
- ROADMAP C15: setMaxNumSdfBlockIntegrateFromGlobalHash after
  streamAllOut loses the reference's whole map (its new Streamer starts
  with an empty grid), and the port's keeps it (P59).
- The memory report's parameter block equals the JAX package's line for
  line, and its device total equals the state's tensors' nbytes.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from mrhash_tpu_torch import params as P
from mrhash_tpu_torch.geowrapper import GeoWrapper

torch.set_num_threads(1)

ROWS, COLS = 64, 256
CAM = (80.0, 80.0, 127.5, 31.5, ROWS, COLS, 0.01, 5.0)
KW = dict(sdf_truncation=0.06, sdf_truncation_scale=0.0,
          integration_weight_sample=1, virtual_voxel_size=0.02,
          n_frames_invalidate_voxels=0, voxel_extents_scale=1,
          gs_optimization_param_path="", num_blocks=1 << 11,
          max_active_blocks=1 << 10, max_alloc_per_frame=1 << 10,
          profiling=False)
GETTERS = ("getHashNumBuckets", "getNumSdfBlocks", "getHashBucketSize",
           "getSdfTruncation", "getSdfTruncationScale",
           "getIntegrationWeightSample", "getIntegrationWeightMax",
           "getVirtualVoxelSize", "getLinkedListSize",
           "getNFramesInvalidateVoxels",
           "getMaxNumSdfBlockIntegrateFromGlobalHash",
           "getVoxelExtentsScale")
REBUILDS = ("setNumSdfBlocks", "setHashNumBuckets", "setVirtualVoxelSize",
            "setVoxelExtentsScale")


def _frames(n=6):
    rng = np.random.default_rng(0)
    r = np.arange(ROWS, dtype=np.float32)[:, None]
    c = np.arange(COLS, dtype=np.float32)[None, :]
    base = 1.6 + 0.3 * np.sin(c / 37.0) + 0.2 * np.cos(r / 17.0)
    rgb = rng.integers(0, 255, (ROWS, COLS, 3)).astype(np.uint8)
    return [(base + rng.normal(0, 0.01, base.shape)).astype(np.float32)
            for _ in range(n)], rgb


def _feed(gw, depths, rgb):
    for d in depths:
        gw.setCurrPose([0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0])
        gw.setDepthImage(d)
        gw.setRGBImage(rgb)
        gw.compute()


def _port(**kw):
    gw = GeoWrapper(device="cpu", **{**KW, **kw})
    gw.setCamera(*CAM)
    return gw


def _key_map(pos, ptr, pool):
    """{block key: (sdf, weight, rgbp, sumsq) rows} of a res-0 map."""
    pos, ptr = np.asarray(pos), np.asarray(ptr)
    occ = ptr != P.FREE_ENTRY
    rows = {tuple(int(v) for v in k): int(p) // 512
            for k, p in zip(pos[occ], ptr[occ])}
    keys = sorted(rows)
    idx = np.asarray([rows[k] for k in keys], np.int64)
    return keys, {f: np.asarray(pool[f])[idx].copy()
                  for f in ("sdf", "weight", "rgbp", "sumsq")}


def _port_map(gw):
    t, pool = gw.state.table, gw.state.pool
    return _key_map(t.pos.numpy(), t.ptr.numpy(),
                    {f: getattr(pool, f).numpy() for f in pool.FIELDS})


def _ref_map(gw):
    t, pool = gw.state.table, gw.state.pool
    return _key_map(t.pos, t.ptr,
                    {f: getattr(pool, f) for f in
                     ("sdf", "weight", "rgbp", "sumsq")})


def _assert_maps_match(got, want):
    (gk, g), (wk, w) = got, want
    assert gk == wk
    np.testing.assert_array_equal(g["weight"], w["weight"])
    upd = w["weight"] > 0
    assert int(upd.sum()) > 10000, "scene integrated nothing"
    np.testing.assert_array_equal(g["rgbp"][upd], w["rgbp"][upd])
    np.testing.assert_allclose(g["sdf"][upd], w["sdf"][upd], atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(g["sumsq"][upd], w["sumsq"][upd], atol=5e-4,
                               rtol=0)


def _ref_wrapper(tmp_path_factory, **kw):
    import os
    from mrhash_tpu.geowrapper import GeoWrapper as JGeoWrapper
    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("ref"))    # its memory report
    try:
        gw = JGeoWrapper(**{**KW, **kw})
    finally:
        os.chdir(cwd)
    gw.setCamera(*CAM)
    return gw


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX GeoWrapper over frames 0-2, setVirtualVoxelSize(0.03),
    frames 3-5 ("before" and "rebuilt" are its maps after frames 2 and 5,
    "gw" the wrapper), and fresh JAX GeoWrappers over frames 3-5 at 0.02 m
    and 0.03 m ("fresh02", "fresh03")."""
    pytest.importorskip("jax")
    depths, rgb = _frames()
    gw = _ref_wrapper(tmp_path_factory)
    _feed(gw, depths[:3], rgb)
    out = dict(before=_ref_map(gw))
    gw.setVirtualVoxelSize(0.03)
    _feed(gw, depths[3:], rgb)
    out.update(rebuilt=_ref_map(gw), gw=gw)
    for name, vvs in (("fresh02", 0.02), ("fresh03", 0.03)):
        fresh = _ref_wrapper(tmp_path_factory, virtual_voxel_size=vvs)
        _feed(fresh, depths[3:], rgb)
        out[name] = _ref_map(fresh)
    return out


def test_setters_match_reference(tmp_path, monkeypatch, capsys):
    pytest.importorskip("jax")
    from mrhash_tpu.geowrapper import GeoWrapper as JGeoWrapper
    monkeypatch.chdir(tmp_path)
    gws = dict(port=GeoWrapper(device="cpu", **KW), ref=JGeoWrapper(**KW))
    calls = [("setNumSdfBlocks", 1 << 12), ("setHashNumBuckets", 1 << 10),
             ("setHashBucketSize", P.HASH_BUCKET_SIZE),
             ("setSdfTruncation", 0.08), ("setSdfTruncationScale", 0.01),
             ("setIntegrationWeightSample", 2),
             ("setIntegrationWeightMax", 100),
             ("setVirtualVoxelSize", 0.03),
             ("setLinkedListSize", P.LINKED_LIST_SIZE),
             ("setNFramesInvalidateVoxels", 5),
             ("setMaxNumSdfBlockIntegrateFromGlobalHash", 1 << 11),
             ("setVoxelExtentsScale", 2),
             ("setIntegrationWeightMax", 300)]
    assert len({name for name, _ in calls}) == 12
    for name, value in calls:
        out = {}
        for k, gw in gws.items():
            getattr(gw, name)(value)
            out[k] = capsys.readouterr().out
        assert out["port"] == out["ref"], name
        port, ref = gws["port"], gws["ref"]
        for g in GETTERS:
            assert getattr(port, g)() == getattr(ref, g)(), (name, g)
        shared = {f.name for f in dataclasses.fields(port.cfg)} & \
            {f.name for f in dataclasses.fields(ref.cfg)}
        assert len(shared) > 20
        for f in sorted(shared):
            assert getattr(port.cfg, f) == getattr(ref.cfg, f), (name, f)
        if name in REBUILDS:     # nothing built from the old config stays
            assert port.streamer.cfg is port.cfg, name
    assert "clamping 300 to 255" in out["port"]
    assert gws["port"].getIntegrationWeightMax() == 255
    assert gws["port"].state.table.num_blocks == 1 << 12
    assert gws["port"].streamer.grid.extents.tolist() == [2.0] * 3
    for name, bad in (("setHashBucketSize", P.HASH_BUCKET_SIZE + 1),
                      ("setLinkedListSize", P.LINKED_LIST_SIZE - 1)):
        msgs = []
        for gw in gws.values():
            with pytest.raises(ValueError) as e:
                getattr(gw, name)(bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], msgs
    gws["port"].close()


def test_rebuild_between_frames_matches_reference(reference, tmp_path,
                                                  monkeypatch):
    """The port's map after the rebuild is held against a fresh JAX
    GeoWrapper at the new voxel size, which is what the reference's
    rebuild means to give (its own rebuilt wrapper does not, C16)."""
    monkeypatch.chdir(tmp_path)
    gw = _port()
    depths, rgb = _frames()
    _feed(gw, depths[:3], rgb)
    _assert_maps_match(_port_map(gw), reference["before"])
    gw.setVirtualVoxelSize(0.03)
    assert gw.state.table.high_count == gw.cfg.num_blocks
    _feed(gw, depths[3:], rgb)
    _assert_maps_match(_port_map(gw), reference["fresh03"])
    assert gw.state.frame == 3
    gw.close()


def test_reference_steps_with_its_old_config_after_a_setter_c16(
        reference, tmp_path_factory, tmp_path, monkeypatch):
    """ROADMAP C16: the reference's compute() reuses the step it compiled
    before a setter (its AOT cache is keyed by window sizes and shapes,
    not by the config), so after setVirtualVoxelSize its map is the old
    voxel size's while its config says the new one; after
    setSdfTruncation it integrates with the old truncation.  The port
    reads its config every frame: its map after setSdfTruncation(0.12)
    equals, within the bounds above, that of a JAX GeoWrapper built with
    the new truncation that took over the plain JAX wrapper's state after
    the same 3 frames, which is what the reference's setter means to
    give."""
    import jax
    gk, g = reference["rebuilt"]
    wk, w = reference["fresh02"]
    assert gk == wk and reference["gw"].getVirtualVoxelSize() == 0.03
    for f in g:
        np.testing.assert_array_equal(g[f], w[f])
    assert gk != reference["fresh03"][0]

    depths, rgb = _frames(4)
    ref = dict(plain=_ref_wrapper(tmp_path_factory),
               set=_ref_wrapper(tmp_path_factory))
    cont = _ref_wrapper(tmp_path_factory, sdf_truncation=0.12)
    monkeypatch.chdir(tmp_path)
    port = dict(plain=_port(), set=_port())
    for gws in (ref, port):
        for name, gw in gws.items():
            _feed(gw, depths[:3], rgb)
            if name == "set":
                gw.setSdfTruncation(0.12)
            if gw is ref["plain"]:
                cont.state = jax.tree_util.tree_map(lambda x: x.copy(),
                                                    gw.state)
                cont._high_free = gw._high_free
            _feed(gw, depths[3:], rgb)
    _feed(cont, depths[3:], rgb)
    maps = {k: _ref_map(gw) for k, gw in ref.items()}
    assert maps["set"][0] == maps["plain"][0]
    np.testing.assert_array_equal(maps["set"][1]["sdf"],
                                  maps["plain"][1]["sdf"])
    want = _ref_map(cont)
    assert len(want[0]) > len(maps["plain"][0])
    _assert_maps_match(_port_map(port["plain"]), maps["plain"])
    _assert_maps_match(_port_map(port["set"]), want)
    for gw in port.values():
        gw.close()


def test_streamer_close_joins_reraises_and_stops(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    depths, rgb = _frames(2)
    threads = threading.active_count()
    gw = _port()
    _feed(gw, depths, rgb)
    n = gw.last_stats["occupied_total"]
    gw.state = gw.streamer.stream_out(gw.state, np.zeros(3), 0.0,
                                      asynchronous=True)
    assert gw.streamer._job is not None
    gw.streamer.close()
    assert gw.streamer.grid.num_blocks() == n > 100
    assert gw.streamer._worker is None and gw.streamer._job is None

    def boom(*_):
        raise RuntimeError("ingest failed")
    _feed(gw, depths, rgb)
    gw.streamer._ingest = boom
    gw.state = gw.streamer.stream_out(gw.state, np.zeros(3), 0.0,
                                      asynchronous=True)
    with pytest.raises(RuntimeError, match="ingest failed"):
        gw.close()
    assert gw.streamer._worker is None and gw.streamer._job is None
    del gw.streamer._ingest
    for i in range(10):
        _feed(gw, depths[:1], rgb)
        gw.state = gw.streamer.stream_out(gw.state, np.zeros(3), 0.0,
                                          asynchronous=True)
        assert gw.streamer._worker is not None
        if i % 2:
            gw.setNumSdfBlocks(1 << 11)
        else:
            gw.setVirtualVoxelSize(0.02)
        assert gw.streamer.grid.num_blocks() == 0
    gw.close()
    assert threading.active_count() == threads


def test_staging_setter_keeps_the_grid_c15(reference, tmp_path,
                                           monkeypatch):
    """ROADMAP C15: the reference replaces its Streamer, and with it the
    host grid, so a map streamed out is gone; the port hands the grid
    over."""
    ref = reference["gw"]
    ref.streamAllOut()
    n = ref.streamer.grid.num_blocks()
    assert n > 100
    ref.setMaxNumSdfBlockIntegrateFromGlobalHash(1 << 10)
    lost = int((np.asarray(ref.state.table.ptr) != P.FREE_ENTRY).sum())
    assert ref.streamer.grid.num_blocks() == 0 and lost == 0

    monkeypatch.chdir(tmp_path)
    gw = _port()
    depths, rgb = _frames()
    _feed(gw, depths[3:], rgb)
    gw.streamAllOut()
    before = gw.streamer.grid.chunks
    assert gw.streamer.grid.num_blocks() == n     # the map of fresh02
    gw.setMaxNumSdfBlockIntegrateFromGlobalHash(1 << 10)
    assert gw.getMaxNumSdfBlockIntegrateFromGlobalHash() == 1 << 10
    assert gw.streamer.grid.chunks is before
    assert gw.streamer.grid.num_blocks() == n
    gw.close()


def test_memory_report_matches_reference(tmp_path, monkeypatch):
    pytest.importorskip("jax")
    from mrhash_tpu.geowrapper import GeoWrapper as JGeoWrapper
    reports = {}
    for name, make in (("port", lambda kw: GeoWrapper(device="cpu", **kw)),
                       ("ref", lambda kw: JGeoWrapper(**kw))):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        gw = make(dict(KW, num_buckets=1 << 9) if name == "port" else KW)
        if name == "ref":
            gw.setHashNumBuckets(1 << 9)
            gw._write_memory_report()
        reports[name] = (tmp_path / name / "memory_allocation.txt"
                         ).read_text().splitlines()
        if name == "port":
            port = gw
    head = reports["ref"].index("=" * 57)
    assert head == 12 and reports["port"][:head + 1] == \
        reports["ref"][:head + 1]
    assert "hash_num_buckets: 512" in reports["port"]
    st = port.state
    tensors = [st.table.pos, st.table.ptr, st.table.res, st.table.fp,
               st.table.heap_high, st.table.heap_low,
               *(getattr(st.pool, f) for f in st.pool.FIELDS)]
    total = next(line for line in reports["port"]
                 if line.startswith("VoxelContainer | total d_size: "))
    assert int(total.split()[4]) == sum(t.nbytes for t in tensors)
    port.close()
