"""The row-sharded frame step (ptdn_tpu_torch/parallel/) on the CPU: the
in-process group's halos against the directly computed rows, kernel D's
shard mode and kernel C's row offset (plain versions) against the
unsharded passes' rows, the stitched sharded frame against the whole
image's in every branch, and two gloo ranks against the in-process
group; all bit for bit (torch.equal). The comparisons with the JAX
package are tests/test_torch_parallel_jax.py."""

import ctypes
import re

import numpy as np
import pytest
import torch

from ptdn_tpu_torch.app.automate import CameraAutomation
from ptdn_tpu_torch.denoise import reproject as trep
from ptdn_tpu_torch.engine import Renderer
from ptdn_tpu_torch.ops.cuda import _lib
from ptdn_tpu_torch.ops.cuda import atrous as D
from ptdn_tpu_torch.ops.cuda import reproject as C
from ptdn_tpu_torch.parallel import sharded as S
from ptdn_tpu_torch.parallel.dryrun import CFG as DRYRUN_CFG
from ptdn_tpu_torch.parallel.dryrun import run_ranks
from ptdn_tpu_torch.parallel.halo import halo_rows
from ptdn_tpu_torch.parallel.mesh import InProcessGroup
from ptdn_tpu_torch.scene import Scene
from ptdn_tpu_torch.utils.config import RenderConfig
from test_torch_kernels import _reproj_inputs
from test_torch_mesh import torch_on_one_thread  # noqa: F401 (autouse)
from test_torch_motion import _motion_args, _torch

RES = (64, 64)       # W x H: 8 shards of 8 rows
SVGF = dict(denoise_enable=True, temporal_enable=True, spatial_enable=True)
# name: (scene, config, frames, the engine the scene takes)
SLICES = {
    "cornell_svgf_d3": ("cornell", dict(SVGF, trace_depth=3,
                                        atrous_nlevel=3), 2, "whole_path"),
    # level 5's 64-row halo spans the eight 8-row shards
    "cornell_svgf_l5": ("cornell", dict(SVGF, trace_depth=2,
                                        atrous_nlevel=5), 2, "whole_path"),
    "room_sorted_l2": ("room", dict(SVGF, trace_depth=2, atrous_nlevel=2),
                       2, "sorted"),
    "diamond_raw": ("diamond", dict(denoise_enable=False, trace_depth=2), 2,
                    "sorted"),
    "cornell_native": ("cornell", dict(SVGF, trace_depth=3, atrous_nlevel=3,
                                       compat=False), 3, "whole_path"),
    # the camera moves every frame: C's band mode, one 64-row band across
    # every shard
    "cornell_anim_slow": ("cornell", dict(SVGF, trace_depth=3,
                                          atrous_nlevel=3,
                                          automate_camera=True,
                                          camera_speed_theta=0.4,
                                          camera_speed_phi=0.08), 3,
                          "whole_path"),
}


def _padded(x, halo):
    pad = torch.zeros((halo,) + tuple(x.shape[1:]), dtype=x.dtype)
    return torch.cat([pad, x, pad])


# ---------------------------------------------------------------------------
# halos

@pytest.mark.parametrize("halo", [4, 8, 24])
def test_halo_rows_in_process(halo):
    """halo_rows on the in-process group (h = 64, 8 shards of 8 rows;
    24 rows take three hops) against the image's rows above and below
    each shard, zeros past the image (tests/test_sharding.py:196-221)."""
    h, w, n = 64, 16, 8
    x = torch.arange(h * w, dtype=torch.float32).reshape(h, w)
    slabs = list(x.reshape(n, h // n, w))
    tops, bottoms = halo_rows(InProcessGroup(n), slabs, halo)
    padded = _padded(x, halo)
    for i, (t, s, b) in enumerate(zip(tops, slabs, bottoms)):
        want = padded[i * 8:i * 8 + 8 + 2 * halo]
        assert torch.equal(torch.cat([t, s, b]), want)


# ---------------------------------------------------------------------------
# kernel D's shard mode

@pytest.fixture(scope="module")
def atrous_inputs():
    """tests/test_torch_kernels.py's atrous_inputs: a 64x48 image."""
    r = np.random.default_rng(3)
    h, w = 64, 48
    x = {"color": r.uniform(size=(h, w, 3)),
         "variance": r.uniform(size=(h, w)),
         "position": r.normal(size=(h, w, 3)),
         "normal": r.normal(size=(h, w, 3)),
         "albedo": r.uniform(size=(h, w, 3))}
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in x.items()}


def shard_halo(cv, r0, hl, halo):
    """(own, (top, bottom)): the rows r0.. of a shard of hl rows of `cv`
    (an image's packed rows with `halo` zero rows above and below), and
    the image's `halo` rows above and below them."""
    return (cv[halo + r0:halo + r0 + hl],
            (cv[r0:r0 + halo], cv[r0 + hl + halo:r0 + hl + 2 * halo]))


def atrous_shards(x, hl, level, blur, albedo):
    """Kernel D's shard mode (plain) on each hl-row shard of the image:
    its rows, and as its halo the image's rows above and below them that
    the level's taps reach (zeros past the image), the G-buffer extended
    by level 5's reach."""
    h = x["variance"].shape[0]
    halo, sh = D.atrous_halo(level), D.atrous_halo(5)
    cv = _padded(torch.cat([x["color"], x["variance"][..., None]], -1),
                 halo)
    static = _padded(D.pack_static_planes(x["position"], x["normal"]), sh)
    out = []
    for r0 in range(0, h, hl):
        own, rows = shard_halo(cv, r0, hl, halo)
        out.append(D.atrous_level(
            own[..., :3], own[..., 3], static[r0:r0 + hl + 2 * sh],
            x["albedo"][r0:r0 + hl] if albedo else None, level, 0.45, 0.2,
            0.35, blur, row0=r0, full_h=h, halo=rows, static_halo=sh))
    return out


@pytest.mark.parametrize("hl", [16, 8])
@pytest.mark.parametrize("level,blur,albedo", [
    (1, True, False), (2, True, False), (3, True, False), (4, True, False),
    (5, True, False), (1, False, False), (3, False, False),
    (5, False, False), (5, True, True)])
def test_atrous_shard_mode_equals_unsharded(atrous_inputs, hl, level, blur,
                                            albedo):
    """D's shard mode on shards of 16 and 8 rows of a 64x48 image, levels
    1-5 with and without the variance blur and level 5 with the albedo,
    against the unsharded level's rows: bit for bit."""
    x = atrous_inputs
    want = D.atrous_level(x["color"], x["variance"],
                          D.pack_static_planes(x["position"], x["normal"]),
                          x["albedo"] if albedo else None, level, 0.45, 0.2,
                          0.35, blur)
    got = atrous_shards(x, hl, level, blur, albedo)
    assert torch.equal(torch.cat([g[0] for g in got]), want[0])
    assert torch.equal(torch.cat([g[1] for g in got]), want[1])


def test_atrous_shard_mode_checks_its_halos():
    """Halo rows short of the level's reach, a G-buffer halo short of
    the halo rows', halo rows of another width, or a shard without halo
    rows are refused."""
    own = torch.zeros((8, 48, 4))
    static = torch.zeros((8 + 2 * 8, 48, 8))
    four = (torch.zeros((4, 48, 4)), torch.zeros((4, 48, 4)))
    with pytest.raises(ValueError):
        D.atrous_level(own[..., :3], own[..., 3], static, None, 2, 0.45,
                       0.2, 0.35, True, row0=8, full_h=64, halo=four,
                       static_halo=8)
    with pytest.raises(ValueError):
        D.atrous_level(own[..., :3], own[..., 3], static[4:-4], None, 1,
                       0.45, 0.2, 0.35, True, row0=8, full_h=64, halo=four,
                       static_halo=2)
    with pytest.raises(ValueError):
        D.atrous_level(own[..., :3], own[..., 3], static, None, 1, 0.45,
                       0.2, 0.35, True, row0=8, full_h=64,
                       halo=(four[0][:, :40], four[1][:, :40]),
                       static_halo=8)
    with pytest.raises(ValueError):
        D.atrous_level(own[..., :3], own[..., 3], static, None, 1, 0.45,
                       0.2, 0.35, True, row0=8, full_h=64, static_halo=8)


@pytest.mark.parametrize("hl", [32, 16, 8])
@pytest.mark.parametrize("level", [1, 2, 3, 4, 5])
def test_atrous_shard_halo_rows_equal_extended_input(atrous_inputs, hl,
                                                     level):
    """D's shard mode (plain) fed its halo rows apart from its own rows
    (top, bottom) against the same level on the input extended by them
    (atrous_extended_plain, the shard mode's earlier form), on 2, 4 and
    8 shards at every level: bit for bit, and the packed and the split
    layouts of the shard's own rows alike."""
    x = atrous_inputs
    h = x["variance"].shape[0]
    halo, sh = D.atrous_halo(level), D.atrous_halo(5)
    cv = _padded(torch.cat([x["color"], x["variance"][..., None]], -1),
                 halo)
    static = _padded(D.pack_static_planes(x["position"], x["normal"]), sh)
    for r0 in range(0, h, hl):
        own, rows = shard_halo(cv, r0, hl, halo)
        st = static[r0:r0 + hl + 2 * sh]
        ext = cv[r0:r0 + hl + 2 * halo]
        want = D.atrous_extended_plain(ext[..., :3], ext[..., 3], st, None,
                                       level, 0.45, 0.2, 0.35, True, True,
                                       r0, h, halo, sh)
        for c, v in ((own[..., :3], own[..., 3]),
                     (own[..., :3].contiguous(), own[..., 3].contiguous())):
            got = D.atrous_level_plain(c, v, st, None, level, 0.45, 0.2,
                                       0.35, True, True, r0, h, rows, sh)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("h,w", [(100, 800), (50, 800), (200, 800),
                                 (12, 96), (37, 29)])
def test_atrous_shard_tiling_covers_every_pixel_once(h, w):
    """D's shard-mode launch geometry (atrous_shard_tiling, the mapping
    of csrc/atrous.cu:atrous_shard_kernel spelt out by
    atrous_shard_pixels) on shards of 100, 50 and 200 rows of an 800-wide
    image and odd sizes, at levels 1-5: each pixel is filtered by exactly
    one thread, a block's warps hold the lattice's rows (row phases where
    a lattice has fewer rows than ROWS, at most MAX_ROW_PHASES), and a
    block stages at most the kernel's ROWS + 4 MAX_ROW_PHASES rows of 48
    pixels."""
    for level in range(1, 6):
        step = 1 << level
        (y, x), (sy, sx) = D.atrous_shard_pixels(h, w, level)
        hits = np.zeros((h, w), np.int64)
        np.add.at(hits, (y, x), 1)
        assert (hits == 1).all(), (level, hits.min(), hits.max())
        blocks, phases, rp, ty, tx = D.atrous_shard_tiling(h, w, level)
        assert phases == min(4, step)
        assert rp <= min(D.MAX_ROW_PHASES, step) and D.ROWS % rp == 0
        assert blocks == step // rp * (step // phases) * ty * tx
        tr = D.ROWS // rp
        assert (tr >= min(-(-h // step), D.ROWS)
                or rp == D.MAX_ROW_PHASES)
        cols = 32 // phases
        assert rp * (tr + 4) * (cols + 4) * phases <= (
            D.ROWS + 4 * D.MAX_ROW_PHASES) * 48
        # the staged pixels reach every tap row of the shard's pixels
        assert sy.min() >= -D.atrous_halo(level)
        assert sy.max() < h + D.atrous_halo(level)


def test_atrous_mirrors_match_csrc():
    """ops/cuda/atrous.py's mirrors of csrc/atrous.cu: the tile geometry
    (ROWS, HALO, MAX_ROW_PHASES as kRows, kHalo, kMaxRowPhases) and the
    fields of AtrousArgs and AtrousShardArgs, by name, order and type."""
    src = (_lib.CSRC / "atrous.cu").read_text()
    for name, value in (("kRows", D.ROWS), ("kHalo", D.HALO),
                        ("kMaxRowPhases", D.MAX_ROW_PHASES)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    ctype = {"int": ctypes.c_int, "float": ctypes.c_float,
             "AtrousArgs": D.AtrousArgs}
    for struct in (D.AtrousArgs, D.AtrousShardArgs):
        body = re.search(rf"struct {struct.__name__} {{(.*?)\n}};", src,
                         re.S).group(1)
        fields = re.findall(r"^\s*(?:const )?(\w+)(\*?) (\w+);", body, re.M)
        assert [f[0] for f in struct._fields_] == [f[2] for f in fields]
        for (_, t), (base, star, _) in zip(struct._fields_, fields):
            assert t is (ctypes.c_void_p if star else ctype[base])


@pytest.mark.parametrize("n,halo", [(8, 4), (8, 8), (8, 20), (4, 64)])
def test_halo_rows_send_only_the_reached_rows(n, halo):
    """halo_rows sends whole slabs over the nearer hops and, over the
    farthest, only the rows its halo reaches (all of a one-hop halo);
    the in-process group's one-hop halo rows are views of the
    neighbours' slabs."""
    h, w = 64, 6
    x = torch.arange(h * w, dtype=torch.float32).reshape(h, w)
    slabs = list(x.reshape(n, h // n, w))
    group, sent = InProcessGroup(n), []
    real = group.shift

    def shift(xs, k):
        sent.append((k, xs[0].shape[0]))
        return real(xs, k)
    group.shift = shift
    tops, bottoms = halo_rows(group, slabs, halo)
    hl = h // n
    hops = -(-halo // hl)
    far = halo - (hops - 1) * hl
    assert sorted(sent) == sorted(
        [(k, hl) for k in range(1, hops)] + [(-k, hl)
                                             for k in range(1, hops)]
        + [(hops, far), (-hops, far)])
    padded = _padded(x, halo)
    for i, (t, b) in enumerate(zip(tops, bottoms)):
        assert torch.equal(t, padded[i * hl:i * hl + halo])
        assert torch.equal(b, padded[i * hl + hl + halo:
                                     i * hl + hl + 2 * halo])
        if hops == 1 and 0 < i < n - 1:
            assert t.data_ptr() == slabs[i - 1][hl - halo:].data_ptr()
            assert b.data_ptr() == slabs[i + 1].data_ptr()


def test_halo_rows_of_no_rows_send_nothing():
    """A halo of 0 rows (a band-mode back-projection whose bands' slabs
    stay within every shard, as in a group of one shard) is empty rows,
    with no exchange."""
    group, sent = InProcessGroup(2), []
    group.shift = lambda xs, k: sent.append(k)
    slabs = list(torch.arange(48.0).reshape(2, 4, 6))
    tops, bottoms = halo_rows(group, slabs, 0)
    assert not sent
    assert all(t.shape == b.shape == (0, 6) for t, b in zip(tops, bottoms))


# ---------------------------------------------------------------------------
# kernel C's row offset

def _stencil_args():
    """test_torch_kernels' 40x48 still-camera inputs as the unsharded
    call's arguments (every base within a pixel: C's stencil domain)."""
    res, cur, st = _reproj_inputs(7)
    t = {k: torch.from_numpy(np.array(v)) for k, v in st.items()}
    gb = {k: torch.from_numpy(cur[k]) for k in ("position", "normal",
                                                 "geom_id")}
    args = (res, torch.from_numpy(cur["color"]), gb,
            {"normal": t["prev_normal"], "geom_id": t["prev_geom_id"]},
            t["prev_view"], t["color_history"], t["moment_history"],
            t["history_length"], 0.2, 0.2)
    assert bool(trep.motion_bounds(res, gb, t["prev_view"])[0])
    return args


def _pan_args(edges=False):
    """A 192x48 pan (3 px a frame across) with one pixel (row 60, col 7)
    flowing 40 rows down, out of its band's slab (rejected), and the
    image's band starts from its shards' motion parts reduced over 4
    shards (motion_bounds' bit for bit): (args, starts on the host). With
    `edges`, 4 pixels of every row flow to the last row of their band's
    slab and 4 to its first (the starts stay [0, 48, 97]), each with a
    history and its geom and normal those of the previous frame at its
    base (a valid tap), so that taps read every row the band rule lets
    them."""
    h, w = 192, 48
    dy = np.zeros((h, w), np.float32)
    if edges:
        slab = trep.slab_rows(h, trep.BAND_ROWS, trep.BAND_MARGIN)
        start = np.array([0, 48, 97])[np.arange(h) // trep.BAND_ROWS]
        # padded slab rows [start, start + slab): image rows start - 1 ..
        # start + slab - 2
        dy[:, 20:24] = (start + slab - 2 - np.arange(h))[:, None]
        dy[:, 24:28] = (start - 1 - np.arange(h))[:, None]
    dy[60, 7] = 40.0
    dx = np.full((h, w), 3.0, np.float32)
    args = _motion_args(h, w, dy, dx)
    if edges:
        cur, prev = args[2], args[3]
        for y in range(h):
            for x in range(20, 28):
                by, bx = y + int(dy[y, x]), x + 3
                if 0 <= by < h:
                    prev["geom_id"][by, bx] = cur["geom_id"][y, x] = 1
                    cur["normal"][y, x] = prev["normal"][by, bx]
                    args[7][y, x] = 3
    args = tuple(_torch(args))
    res, _, gb, _, view = args[:5]
    want_bounds = trep.motion_bounds(res, gb, view)
    group = InProcessGroup(4)
    parts = [trep.motion_parts((w, 48), {k: v[r0:r0 + 48]
                                         for k, v in gb.items()},
                               view, trep.BAND_ROWS, r0, h)
             for r0 in range(0, h, 48)]
    reach = group.reduce([p[0] for p in parts], "max")
    sums = group.reduce([torch.stack(p[1:]) for p in parts], "sum")
    bounds = trep.bounds_from_parts(reach, sums[0], sums[1], h)
    assert torch.equal(bounds, want_bounds) and not bool(bounds[0])
    if edges:
        assert bounds[1:].tolist() == [0, 48, 97]
    return args, bounds[1:].tolist()


def _shard_calls(args, hl, starts=None, k=None):
    """parallel/sharded.py:back_projection_shards on hl-row shards:
    [(shard args without the band's, rows, halo)], k."""
    calls, k = S.back_projection_shards(args, args[0][1] // hl, starts, k)
    return [(a[:10], kw["rows"], kw["halo"]) for a, kw in calls], k


def _window_call(args, sargs, rows, k):
    """The window form of a shard-form call, built from the image
    directly: the previous frame's rows from k above the shard's to k
    below (zeros past the image)."""
    prev_gb, ch, mh, hl_prev = args[3], *args[5:8]
    r0, h = rows
    hl = sargs[0][1]
    win = [_padded(t, k)[r0:r0 + hl + 2 * k] for t in (
        prev_gb["normal"], prev_gb["geom_id"], ch, mh, hl_prev)]
    wargs = (sargs[:3] + ({"normal": win[0], "geom_id": win[1]}, sargs[4])
             + tuple(win[2:]) + sargs[8:])
    return wargs, (r0, h, r0 - k)


def _check_shards(args, hl, starts=None, k=None):
    """Every hl-row shard's shard-form call (plain) equals the window
    form's plain version and the unsharded pass's rows, bit for bit, every
    output."""
    h = args[0][1]
    band = () if starts is None else (starts, trep.BAND_ROWS,
                                      trep.BAND_MARGIN)
    if starts is None:
        want = C.back_projection_stencil(*args)
        fn, window_fn = (C.back_projection_stencil,
                         C.back_projection_stencil_window_plain)
    else:
        want = C.back_projection_banded(*args, torch.tensor(
            starts, dtype=torch.int32), *band[1:])
        fn, window_fn = (C.back_projection_banded,
                         C.back_projection_banded_window_plain)
    calls, k = _shard_calls(args, hl, starts, k)
    got = []
    for sargs, rows, halo in calls:
        out = fn(*sargs, *band, rows=rows, halo=halo)
        wargs, wrows = _window_call(args, sargs, rows, k)
        for g, w_ in zip(out, window_fn(*wargs, *band, rows=wrows)):
            assert torch.equal(g, w_)
        got.append(out)
    for i, w_ in enumerate(want):
        assert torch.equal(torch.cat([g[i] for g in got]), w_)
    return want, k


@pytest.mark.parametrize("hl", [1, 2, 8, 20])
def test_stencil_row_offset_equals_unsharded(hl):
    """C's stencil mode in shard form (its own rows in place, 2 halo rows
    from halo_pack through halo_rows: two hops on 1-row shards) on shards
    of test_torch_kernels' 40x48 still-camera inputs, against the window
    form's plain version and the unsharded pass's rows: bit for bit,
    every output."""
    _check_shards(_stencil_args(), hl)


def test_band_row_offset_equals_unsharded():
    """C's band mode in shard form on 4 shards of 48 rows of a 192x48 pan
    with one pixel flowing 40 rows down (out of its band's slab:
    rejected); bands of 64 rows straddle the shards. Each shard's motion
    parts reduced over the group give motion_bounds' flag and band starts;
    the halo is band_halo's, the rows the shards' bands' slabs reach (50:
    two hops); the shards' rows equal the window form's plain version and
    the unsharded pass's: bit for bit."""
    args, starts = _pan_args()
    want, k = _check_shards(args, 48, starts)
    assert int(want[3][60, 7]) == 1
    assert k == 50


@pytest.mark.parametrize("hl", [1, 2])
def test_band_row_offset_multi_hop(hl):
    """C's band mode in shard form on shards of 1 and 2 rows of the pan:
    halos of band_halo's rows in as many hops, bit for bit to the window
    form and the unsharded rows."""
    args, starts = _pan_args()
    _, k = _check_shards(args, hl, starts)
    assert k > 25 * hl


def test_band_halo_is_the_bands_reach():
    """Rows.reach in band mode against the rows the pixels' taps can
    read, counted from the band rule: for every shard of the pan at 48,
    8 and 2 rows, the rows above and below the shard that some tap of a
    pixel whose base lies in its band's slab reads, and band_halo the
    largest over the shards, the same on every shard."""
    args, starts = _pan_args()
    h = args[0][1]
    slab = trep.slab_rows(h, trep.BAND_ROWS, trep.BAND_MARGIN)
    for hl in (48, 8, 2):
        reaches = []
        for r0 in range(0, h, hl):
            rows = set()
            for y in range(r0, r0 + hl):
                s = starts[y // trep.BAND_ROWS]
                # bases fy with clip(fy + 1, 0, h + 1) in the slab, and
                # their tap rows inside the image
                for fy in range(-2, h + 1):
                    if s <= min(max(fy + 1, 0), h + 1) < s + slab:
                        rows |= {q for q in (fy - 1, fy, fy + 1)
                                 if 0 <= q < h}
            want = (r0 - min(rows), max(rows) - (r0 + hl - 1))
            assert trep.Rows.reach(r0, hl, h, starts) == tuple(
                max(x, 0) for x in want)
            reaches.append(max(want))
        assert trep.band_halo(starts, hl, h) == max(reaches)


@pytest.mark.parametrize("mode", ["stencil", "band"])
def test_row_offset_reads_only_its_halo(mode):
    """Every previous-frame row outside a shard's computed reach
    (Rows.reach: 2 rows in stencil mode, its bands' slabs in band mode)
    filled with NaN and geom -1 before its halo rows are packed and sent
    (a halo of 4 rows in stencil mode, band_halo's in band mode, so the
    halo holds poisoned rows): all four outputs of every shard unchanged,
    bit for bit. In band mode some of the pan's pixels flow to their
    slabs' first and last rows (_pan_args' edges). The plain version
    gathers every tap it may read, valid or not, so a poisoned row it
    read would turn its output NaN."""
    if mode == "stencil":
        args, starts, hl, k = _stencil_args(), None, 8, 4
    else:
        (args, starts), hl, k = _pan_args(edges=True), 48, None
    (w, h) = args[0]
    want = _shard_calls(args, hl, starts, k)[0]
    band = () if starts is None else (starts, trep.BAND_ROWS,
                                      trep.BAND_MARGIN)
    fn = C.back_projection_stencil if starts is None else (
        C.back_projection_banded)
    for r0 in range(0, h, hl):
        above, below = trep.Rows.reach(r0, hl, h, starts)
        keep = torch.zeros(h, dtype=torch.bool)
        keep[r0 - above:r0 + hl + below] = True
        poisoned = list(args)
        prev_gb = dict(args[3])
        prev_gb["geom_id"] = torch.where(keep[:, None], prev_gb["geom_id"],
                                         -1)
        prev_gb["normal"] = torch.where(keep[:, None, None],
                                        prev_gb["normal"], float("nan"))
        poisoned[3] = prev_gb
        for i in (5, 6):
            poisoned[i] = torch.where(keep[:, None, None], args[i],
                                      float("nan"))
        calls, kk = _shard_calls(tuple(poisoned), hl, starts, k)
        sargs, rows, halo = calls[r0 // hl]
        assert (not keep.all()) and kk >= max(above, below)
        got = fn(*sargs, *band, rows=rows, halo=halo)
        ref = fn(*want[r0 // hl][0], *band, rows=rows,
                 halo=want[r0 // hl][2])
        for g, r_ in zip(got, ref):
            assert torch.equal(g, r_)


def test_row_offset_refuses_a_short_window():
    """The halo rows must reach every row the taps may read: 2 in stencil
    mode where the image has them, the bands' slabs' reach in band mode;
    rows and halo come together."""
    args = _stencil_args()
    calls, _ = _shard_calls(args, 8, k=1)
    sargs, rows, halo = calls[1]
    with pytest.raises(ValueError):
        C.back_projection_stencil(*sargs, rows=rows, halo=halo)
    with pytest.raises(ValueError):
        C.back_projection_stencil(*sargs, rows=rows)
    pan, starts = _pan_args()
    k = trep.band_halo(starts, 48, 192)
    calls, _ = _shard_calls(pan, 48, starts, k - 1)
    band = (starts, trep.BAND_ROWS, trep.BAND_MARGIN)
    refused = 0
    for sargs, rows, halo in calls:
        if max(trep.Rows.reach(rows[0], 48, 192, starts)) == k:
            with pytest.raises(ValueError):
                C.back_projection_banded(*sargs, *band, rows=rows,
                                         halo=halo)
            refused += 1
    assert refused >= 1


def test_reproject_mirrors_match_csrc():
    """ops/cuda/reproject.py's mirrors of csrc/reproject.cu and
    reproject.cuh: the tile geometry (TILE_W, TILE_H, REACH,
    MAX_SHARD_BANDS as kTileW, kTileH, kReach, kMaxShardBands) and the
    fields of ReprojArgs and ReprojShardArgs, by name, order and type
    (arrays by length)."""
    src = ((_lib.CSRC / "reproject.cuh").read_text()
           + (_lib.CSRC / "reproject.cu").read_text())
    for name, value in (("kTileW", C.TILE_W), ("kTileH", C.TILE_H),
                        ("kReach", C.REACH), ("kPacked", C.PACKED),
                        ("kMaxShardBands", C.MAX_SHARD_BANDS)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    ctype = {"int": ctypes.c_int, "float": ctypes.c_float,
             "ReprojArgs": C.ReprojArgs}
    for struct in (C.ReprojArgs, C.ReprojShardArgs):
        body = re.search(rf"struct {struct.__name__} {{(.*?)\n}};", src,
                         re.S).group(1)
        fields = re.findall(r"^\s*(?:const )?(\w+)(\*?) (\w+)(?:\[(\w+)\])?;",
                            body, re.M)
        assert [f[0] for f in struct._fields_] == [f[2] for f in fields]
        for (_, t), (base, star, _, n) in zip(struct._fields_, fields):
            if n:
                assert t._length_ == C.MAX_SHARD_BANDS and n == (
                    "kMaxShardBands") and t._type_ is ctype[base]
            else:
                assert t is (ctypes.c_void_p if star else ctype[base])


def test_normal_distance_bound_is_the_square_roots():
    """reproject.cuh:kNormalDist2 is the largest float32 whose square
    root is at most 0.1f: the kernels' tap test d2 <= kNormalDist2 then
    equals the plain versions' sqrt(d2) <= 0.1 on every float32 d2, a
    correctly rounded square root being monotonic."""
    src = (_lib.CSRC / "reproject.cuh").read_text()
    lit = re.search(r"constexpr float kNormalDist2 = (\S+)f;", src).group(1)
    c = torch.tensor(float.fromhex(lit), dtype=torch.float32)
    assert float(c) == float.fromhex(lit)
    nxt = torch.nextafter(c, torch.tensor(float("inf")))
    tenth = torch.tensor(0.1, dtype=torch.float32)
    assert torch.sqrt(c) <= tenth and torch.sqrt(nxt) > tenth
    d2 = torch.cat([torch.linspace(0.0, 0.02, 4001),
                    c + torch.arange(-64, 65) * (nxt - c)])
    assert torch.equal(d2 <= c, torch.sqrt(d2) <= tenth)


@pytest.mark.parametrize("mode", ["stencil", "band"])
def test_tap_rows_hold_every_row_read(mode):
    """ops/cuda/reproject.py:tap_rows, the previous-frame rows a shard's
    taps read (the rows its bound counts): every other row of the image
    filled with NaN and geom -1 before the halo rows are packed and sent
    leaves all four outputs of every shard unchanged, bit for bit. They
    lie within Rows.reach, and in band mode the pan's 48-row shards read
    fewer rows than their bands' slabs reach."""
    if mode == "stencil":
        args, starts, hl, k = _stencil_args(), None, 8, 4
    else:
        (args, starts), hl, k = _pan_args(edges=True), 48, None
    (w, h) = args[0]
    want = _shard_calls(args, hl, starts, k)[0]
    band = () if starts is None else (starts, trep.BAND_ROWS,
                                      trep.BAND_MARGIN)
    fn = C.back_projection_stencil if starts is None else (
        C.back_projection_banded)
    fewer = 0
    for r0 in range(0, h, hl):
        sargs = want[r0 // hl][0]
        keep = C.tap_rows(sargs[0], sargs[2], sargs[4], sargs[7],
                          (r0, h), band or None)
        above, below = trep.Rows.reach(r0, hl, h, starts)
        rows = torch.nonzero(keep)[:, 0]
        assert int(rows.min()) >= r0 - above
        assert int(rows.max()) < r0 + hl + below
        fewer += int(keep.sum()) < hl + above + below
        poisoned = list(args)
        prev_gb = dict(args[3])
        prev_gb["geom_id"] = torch.where(keep[:, None], prev_gb["geom_id"],
                                         -1)
        prev_gb["normal"] = torch.where(keep[:, None, None],
                                        prev_gb["normal"], float("nan"))
        poisoned[3] = prev_gb
        for i in (5, 6):
            poisoned[i] = torch.where(keep[:, None, None], args[i],
                                      float("nan"))
        calls, _ = _shard_calls(tuple(poisoned), hl, starts, k)
        sargs, rows_, halo = calls[r0 // hl]
        got = fn(*sargs, *band, rows=rows_, halo=halo)
        ref = fn(*want[r0 // hl][0], *band, rows=rows_,
                 halo=want[r0 // hl][2])
        for g, r_ in zip(got, ref):
            assert torch.equal(g, r_)
    assert mode == "stencil" or fewer == h // hl


def test_moved_frame_exchanges_a_bounded_halo():
    """The sharded denoiser's moved frame (temporal only, the pan's
    inputs as its state and G-buffer) on 4 shards of 48 rows: each shard
    reads the host bounds once, computes the same band-mode halo
    (band_halo, 50 rows, under the 144 rows a whole-image window would
    add), and its group fulfils two Reduce and one Halo, no whole-image
    exchange; the stitched output, moments and history equal the whole
    image's denoiser's bit for bit."""
    from ptdn_tpu_torch.denoise.svgf import SVGFDenoiser

    args, starts = _pan_args()
    (w, h), color, gb, prev_gb, view, ch, mh, hl_prev, _, _ = args
    cfg = RenderConfig(denoise_enable=True, temporal_enable=True,
                       spatial_enable=False)
    params = {"sigma_l": 0.45, "sigma_n": 0.2, "sigma_x": 0.35,
              "color_alpha": 0.2, "moment_alpha": 0.2}
    state = {"color_history": ch, "moment_history": mh,
             "history_length": hl_prev, "prev_normal": prev_gb["normal"],
             "prev_geom_id": prev_gb["geom_id"], "prev_view": view}

    def denoiser(rows, cut):
        d = SVGFDenoiser(cfg, (w, cut.stop - cut.start), "cpu", rows=rows)
        for k, v in state.items():
            setattr(d, k, v if k == "prev_view" else v[cut].clone())
        return d

    whole = denoiser(None, slice(0, h))
    want = whole(color, gb, torch.eye(4), params, True)
    group = InProcessGroup(4)
    shards = [denoiser((r0, h), slice(r0, r0 + 48))
              for r0 in range(0, h, 48)]
    outs = group.run(d.frame_gen(color[r0:r0 + 48],
                                 {k: v[r0:r0 + 48] for k, v in gb.items()},
                                 torch.eye(4), params, True)
                     for d, r0 in zip(shards, range(0, h, 48)))
    assert dict(group.exchanges) == {"Reduce": 2, "Halo": 1}
    assert {d.moved_halo for d in shards} == {50}
    assert all(d.band_starts == starts and not d.near for d in shards)
    assert torch.equal(torch.cat(outs), want)
    for k in ("moment_history", "history_length"):
        assert torch.equal(torch.cat([getattr(d, k) for d in shards]),
                           getattr(whole, k))


# ---------------------------------------------------------------------------
# the slice

def _frames(renderer, cfg, frames):
    auto = CameraAutomation(cfg)
    out = []
    for _ in range(frames):
        if auto.step(renderer.camera):
            renderer.cam_changed = True
        out.append(renderer.render_frame())
    return out


@pytest.mark.parametrize("name", sorted(SLICES))
def test_sharded_frames_equal_unsharded(scenes_dir, name):
    """8 shards of 8 rows in one process, at 64x64 on the CPU, against
    the whole image's frames: left and right bit for bit on every frame
    (tests/test_sharding.py's configs: cornell with temporal SVGF at 3
    and 5 levels, room through the sorted engine, diamond's raw frame
    through G; and cornell in native mode (R) and with the anim_slow
    camera (C's band mode)). The image is square, where a still camera
    reprojects within a pixel: frame 0 takes C's band mode, the still
    frames after it C's stencil mode (at test_sharding.py's 48x64 every
    frame takes the band mode)."""
    scene_name, kw, frames, engine = SLICES[name]
    scene = Scene(str(scenes_dir / f"{scene_name}.txt"))
    cfg = RenderConfig(**kw)
    want = _frames(Renderer(scene, cfg, RES, device="cpu"), cfg, frames)
    r = S.ShardedRenderer(scene, cfg, RES, InProcessGroup(8), device="cpu")
    assert all(s.tracer.engine == engine for s in r.step.steps)
    got = _frames(r, cfg, frames)
    for (gl, gr), (wl, wr) in zip(got, want):
        assert torch.equal(gl, wl) and torch.equal(gr, wr)
    if cfg.temporal_enable and cfg.denoise_enable:
        # the last frame's branch: near (C's stencil) unless the camera
        # moves
        assert r.step.steps[0].denoiser.near == (not cfg.automate_camera)


def test_sharded_step_returns_shard_rows(scenes_dir):
    """forward gives each shard's (left, right) rows, gather the image,
    frame_state the image's state (the whole image's, bit for bit); the
    shards share one scene build."""
    scene = Scene(str(scenes_dir / "cornell.txt"))
    cfg = RenderConfig(**SLICES["cornell_svgf_d3"][1])
    step = S.make_sharded_step(scene, cfg, RES, InProcessGroup(8), "cpu")
    one = Renderer(scene, cfg, RES, device="cpu")
    one.render_frame()
    cam, vm = one._cam
    outs = step(cam, vm, cfg.traced_params(), 0, True)
    assert len(outs) == 8
    assert all(o[1].shape == (8, 64, 3) for o in outs)
    left, right = step.gather(outs)
    assert left.shape == right.shape == (64, 64, 3)
    state, want = step.frame_state(), one.step.frame_state()
    assert state.keys() == want.keys()
    for k in want:
        assert torch.equal(state[k], want[k]), k
    tracers = [s.tracer for s in step.steps]
    assert all(t.gi is tracers[0].gi for t in tracers)
    assert all(t.mat_attr is tracers[0].mat_attr for t in tracers)


def test_uneven_height_rejected(scenes_dir):
    scene = Scene(str(scenes_dir / "cornell.txt"))
    with pytest.raises(ValueError):
        S.make_sharded_step(scene, RenderConfig(), (48, 31),
                            InProcessGroup(8), "cpu")


def test_sharded_step_on_cuda_without_card_raises(scenes_dir):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        S.make_sharded_step(Scene(str(scenes_dir / "cornell.txt")),
                            RenderConfig(), (48, 64), InProcessGroup(8))


def test_two_gloo_ranks_equal_in_process(scenes_dir, tmp_path):
    """Two torch.distributed ranks over gloo on the CPU, each holding one
    32-row shard of a 32x64 cornell frame (2 frames, 5 levels: level 5's
    64-row halo spans both shards and the image's edge), rendezvousing
    through a file in tmp_path, within 240 s: the stitched frame equals
    the in-process group's bit for bit."""
    res = (32, 64)
    got = run_ranks(2, "cornell", DRYRUN_CFG, res, 2, "cpu", timeout=240,
                    tmp=str(tmp_path))
    r = S.ShardedRenderer(Scene(str(scenes_dir / "cornell.txt")),
                          RenderConfig(**DRYRUN_CFG), res, InProcessGroup(2),
                          device="cpu")
    r.render_frame()
    want = r.render_frame()
    assert np.array_equal(got[0], want[0].numpy())
    assert np.array_equal(got[1], want[1].numpy())
