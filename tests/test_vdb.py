"""OpenVDB codec tests (xraytracer/tools/vdb.py).

Two independent validation axes:

* **Golden byte fixtures** assembled field-by-field in THIS file with raw
  ``struct``/``zlib`` — sharing no code with the codec — following the
  documented archive layout (openvdb/io/Archive.cc, io/Compression.h,
  tree/*Node.h). A reader/writer pair that shared a layout bug would pass
  roundtrips but fail these.
* **Write/read roundtrips** across compression modes, plus structural
  assertions on the written byte stream (no header compression field at
  version 224, per-grid compression word at gridPos, hyphenated uuid,
  leaf value mask re-serialized in the buffer pass).

Pure numpy — no JAX involved.
"""

import struct
import zlib

import numpy as np
import pytest

from xraytracer.tools import vdb as xvdb


# ---------------------------------------------------------------------------
# Independent fixture assembly (no xvdb helpers on purpose)
# ---------------------------------------------------------------------------
def _s(text):
    b = text.encode()
    return struct.pack("<I", len(b)) + b


def _mask(bits):
    return np.packbits(np.asarray(bits, bool).astype(np.uint8),
                       bitorder="little").tobytes()


def _zip_frame(raw):
    comp = zlib.compress(raw)
    return struct.pack("<q", len(comp)) + comp


def _meta_entry(name, typ, payload):
    return _s(name) + _s(typ) + struct.pack("<I", len(payload)) + payload


def _metamap(entries):
    return struct.pack("<I", len(entries)) + b"".join(entries)


def _scale_translate_map(scale, trans):
    scale = np.asarray(scale, np.float64)
    trans = np.asarray(trans, np.float64)
    inv = 1.0 / scale
    out = _s("ScaleTranslateMap")
    for vec in (trans, scale, scale, inv, inv * inv, 0.5 * inv):
        out += struct.pack("<3d", *vec)
    return out


def _leaf_values():
    """A deterministic 8x8x8 leaf: a handful of active voxels."""
    rng = np.random.RandomState(7)
    vals = np.zeros(512, np.float32)
    active = np.zeros(512, bool)
    idx = rng.choice(512, 40, replace=False)
    vals[idx] = rng.uniform(0.1, 1.0, 40).astype(np.float32)
    active[idx] = True
    return vals, active


def _build_v224_fixture():
    """One FloatGrid 'density', single leaf at ijk (0,0,0), zip+active-mask,
    file format 224 — the layout every modern writer emits."""
    vals, active = _leaf_values()
    zipmask = xvdb.COMPRESS_ZIP | xvdb.COMPRESS_ACTIVE_MASK

    n5_children = np.zeros(32768, bool)
    n5_children[0] = True
    n4_children = np.zeros(4096, bool)
    n4_children[0] = True
    empty32768 = _mask(np.zeros(32768, bool))
    empty4096 = _mask(np.zeros(4096, bool))

    # metadata code 0 (inactive == background) + zip frame of active values
    def packed(v, m):
        return b"\x00" + _zip_frame(v[m].astype("<f4").tobytes())

    topo = struct.pack("<i", 1)                     # TreeBase buffer count
    topo += struct.pack("<f", 0.0)                  # root background
    topo += struct.pack("<II", 0, 1)                # tiles, children
    topo += struct.pack("<3i", 0, 0, 0)             # N5 child origin
    topo += _mask(n5_children) + empty32768         # N5 child/value masks
    topo += packed(np.zeros(32768, np.float32), np.zeros(32768, bool))
    topo += _mask(n4_children) + empty4096          # N4 child/value masks
    topo += packed(np.zeros(4096, np.float32), np.zeros(4096, bool))
    topo += _mask(active)                           # leaf value mask (topo)

    buffers = _mask(active)                         # leaf value mask (again!)
    buffers += packed(vals, active)

    gridblk = struct.pack("<I", zipmask)            # per-grid compression
    gridblk += _metamap([
        _meta_entry("class", "string", b"fog volume"),
        _meta_entry("file_compression", "string", b"zip + active values"),
        _meta_entry("name", "string", b"density"),
    ])
    gridblk += _scale_translate_map((0.5, 0.5, 0.5), (1.0, -2.0, 3.0))
    gridblk += topo

    header = struct.pack("<q", 0x56444220)          # magic
    header += struct.pack("<III", 224, 11, 0)       # file + lib version
    header += b"\x01"                               # has grid offsets
    header += b"d2f10c11-79a9-4f2e-a378-0f4f2b1c8d4a"  # uuid (36 ASCII)
    header += _metamap([])                          # file metadata
    header += struct.pack("<i", 1)                  # grid count

    desc = _s("density") + _s("Tree_float_5_4_3") + _s("")
    grid_pos = len(header) + len(desc) + 24
    block_pos = grid_pos + len(gridblk)
    end_pos = block_pos + len(buffers)
    desc += struct.pack("<3q", grid_pos, block_pos, end_pos)
    return header + desc + gridblk + buffers, vals, active


def _build_v221_fixture():
    """Same grid in the legacy [220,222) layout: header is-compressed char,
    NO per-grid compression word, NO per-buffer metadata byte, full
    (unmasked) zip payloads, leaf buffers carry origin + buffer count."""
    vals, active = _leaf_values()

    n5_children = np.zeros(32768, bool)
    n5_children[0] = True
    n4_children = np.zeros(4096, bool)
    n4_children[0] = True

    topo = struct.pack("<i", 1)
    topo += struct.pack("<f", 0.0)
    topo += struct.pack("<II", 0, 1)
    topo += struct.pack("<3i", 0, 0, 0)
    topo += _mask(n5_children) + _mask(np.zeros(32768, bool))
    topo += _zip_frame(np.zeros(32768, np.float32).tobytes())
    topo += _mask(n4_children) + _mask(np.zeros(4096, bool))
    topo += _zip_frame(np.zeros(4096, np.float32).tobytes())
    topo += _mask(active)

    buffers = _mask(active)                         # leaf value mask
    buffers += struct.pack("<3i", 0, 0, 0)          # leaf origin (pre-222)
    buffers += struct.pack("<b", 1)                 # buffer count (pre-222)
    buffers += _zip_frame(vals.astype("<f4").tobytes())

    gridblk = _metamap([_meta_entry("name", "string", b"density")])
    gridblk += _scale_translate_map((0.5, 0.5, 0.5), (1.0, -2.0, 3.0))
    gridblk += topo

    header = struct.pack("<q", 0x56444220)
    header += struct.pack("<III", 221, 2, 3)
    header += b"\x01"                               # has grid offsets
    header += b"\x01"                               # is-compressed char (zip)
    header += b"00000000-0000-0000-0000-000000000000"
    header += _metamap([])
    header += struct.pack("<i", 1)

    desc = _s("density") + _s("Tree_float_5_4_3") + _s("")
    grid_pos = len(header) + len(desc) + 24
    block_pos = grid_pos + len(gridblk)
    end_pos = block_pos + len(buffers)
    desc += struct.pack("<3q", grid_pos, block_pos, end_pos)
    return header + desc + gridblk + buffers, vals, active


# ---------------------------------------------------------------------------
# Golden fixture reads
# ---------------------------------------------------------------------------
def test_read_golden_v224(tmp_path):
    blob, vals, active = _build_v224_fixture()
    p = tmp_path / "golden224.vdb"
    p.write_bytes(blob)
    g = xvdb.read_vdb(str(p))
    assert g.name == "density"
    assert g.meta["file_compression"] == "zip + active values"
    on = np.flatnonzero(active)
    lo = np.array([on >> 6, (on >> 3) & 7, on & 7]).min(axis=1)
    dense_full = np.zeros((8, 8, 8), np.float32)
    dense_full[on >> 6, (on >> 3) & 7, on & 7] = vals[on]
    window = dense_full[lo[0]:, lo[1]:, lo[2]:][
        :g.dense.shape[0], :g.dense.shape[1], :g.dense.shape[2]]
    np.testing.assert_array_equal(g.dense, window)
    np.testing.assert_array_equal(g.bbox_min, lo)
    np.testing.assert_allclose(g.scale, 0.5)
    np.testing.assert_allclose(g.translation, (1.0, -2.0, 3.0))


def test_read_golden_v221_legacy_layout(tmp_path):
    blob, vals, active = _build_v221_fixture()
    p = tmp_path / "golden221.vdb"
    p.write_bytes(blob)
    g = xvdb.read_vdb(str(p))
    on = np.flatnonzero(active)
    got = g.dense[(on >> 6) - g.bbox_min[0], ((on >> 3) & 7) - g.bbox_min[1],
                  (on & 7) - g.bbox_min[2]]
    np.testing.assert_array_equal(got, vals[on])


# ---------------------------------------------------------------------------
# Writer structure (what openvdb::io::File would see)
# ---------------------------------------------------------------------------
def _written_sample(tmp_path, **kw):
    rng = np.random.RandomState(3)
    dense = np.where(rng.rand(12, 9, 16) > 0.7,
                     rng.uniform(0.1, 1.0, size=(12, 9, 16)),
                     0.0).astype(np.float32)
    p = tmp_path / "out.vdb"
    xvdb.write_vdb(str(p), dense, voxel_size=0.25,
                   translation=(2.0, 0.0, -1.0), **kw)
    return p, dense


def test_written_header_layout(tmp_path):
    p, _ = _written_sample(tmp_path, compression="zip")
    raw = p.read_bytes()
    assert struct.unpack_from("<q", raw, 0)[0] == 0x56444220
    assert struct.unpack_from("<I", raw, 8)[0] == 224
    assert raw[20] == 1                     # has grid offsets
    uuid = raw[21:57].decode()              # immediately after — no u32 field
    assert uuid[8] == uuid[13] == uuid[18] == uuid[23] == "-"
    assert all(c in "0123456789abcdefABCDEF-" for c in uuid)
    # file metamap count then grid count
    n_meta = struct.unpack_from("<I", raw, 57)[0]
    assert n_meta == 0
    assert struct.unpack_from("<i", raw, 61)[0] == 1
    # descriptor: unique name, type, parent, then 3 offsets
    off = 65
    for _ in range(3):
        n = struct.unpack_from("<I", raw, off)[0]
        off += 4 + n
    grid_pos, block_pos, end_pos = struct.unpack_from("<3q", raw, off)
    assert off + 24 == grid_pos and grid_pos < block_pos <= end_pos == len(raw)
    # per-grid compression word at gridPos (version >= 222)
    comp = struct.unpack_from("<I", raw, grid_pos)[0]
    assert comp == xvdb.COMPRESS_ZIP | xvdb.COMPRESS_ACTIVE_MASK
    # leaf buffer pass starts with the 64-byte value mask, then the int8
    # metadata code of the first compressed-values record
    assert raw[block_pos + 64] in (0, 6)


def test_written_file_compression_metadata_is_string(tmp_path):
    p, _ = _written_sample(tmp_path, compression="zip")
    g = xvdb.read_vdb(str(p))
    assert g.meta["file_compression"] == "zip + active values"


# ---------------------------------------------------------------------------
# Roundtrips
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("compression", ["none", "zip"])
@pytest.mark.parametrize("half", [False, True])
def test_roundtrip(tmp_path, compression, half):
    rng = np.random.RandomState(11)
    dense = np.where(rng.rand(20, 14, 9) > 0.6,
                     rng.uniform(0.05, 2.0, (20, 14, 9)), 0.0)
    dense = dense.astype(np.float32)
    p = tmp_path / "rt.vdb"
    xvdb.write_vdb(str(p), dense, voxel_size=(0.5, 1.0, 2.0),
                   translation=(-3.0, 0.5, 9.0), origin_ijk=(-16, 8, 0),
                   compression=compression, half=half)
    g = xvdb.read_vdb(str(p))
    # reader window is the active bbox; embed it back into the input frame
    out = np.zeros_like(dense)
    lo = g.bbox_min - np.array([-16, 8, 0])
    out[lo[0]:lo[0] + g.dense.shape[0], lo[1]:lo[1] + g.dense.shape[1],
        lo[2]:lo[2] + g.dense.shape[2]] = g.dense
    if half:
        np.testing.assert_array_equal(
            out, dense.astype(np.float16).astype(np.float32))
    else:
        np.testing.assert_array_equal(out, dense)
    np.testing.assert_allclose(g.scale, (0.5, 1.0, 2.0))
    np.testing.assert_allclose(g.translation, (-3.0, 0.5, 9.0))


@pytest.mark.skipif(not xvdb.blosc_available(), reason="no libblosc")
def test_roundtrip_blosc(tmp_path):
    rng = np.random.RandomState(5)
    dense = np.where(rng.rand(9, 9, 9) > 0.5,
                     rng.uniform(0.1, 1.0, (9, 9, 9)), 0.0).astype(np.float32)
    p = tmp_path / "b.vdb"
    xvdb.write_vdb(str(p), dense, compression="blosc")
    g = xvdb.read_vdb(str(p))
    out = np.zeros_like(dense)
    lo = g.bbox_min
    out[lo[0]:lo[0] + g.dense.shape[0], lo[1]:lo[1] + g.dense.shape[1],
        lo[2]:lo[2] + g.dense.shape[2]] = g.dense
    np.testing.assert_array_equal(out, dense)


# ---------------------------------------------------------------------------
# Failure modes fall back cleanly (ADVICE r2: grid_convert fallback)
# ---------------------------------------------------------------------------
def test_grid_convert_falls_back_on_garbage(tmp_path):
    from xraytracer.tools.grid_convert import convert_vdb
    p = tmp_path / "junk.vdb"
    p.write_bytes(b"\x20\x42\x44\x56\x00\x00\x00\x00" + b"\x99" * 64)
    with pytest.raises(SystemExit):
        convert_vdb(str(p))


def test_grid_convert_survives_truncated_stream(tmp_path):
    from xraytracer.tools.grid_convert import convert_vdb
    blob, _, _ = _build_v224_fixture()
    p = tmp_path / "trunc.vdb"
    p.write_bytes(blob[: len(blob) // 2])
    with pytest.raises(SystemExit):
        convert_vdb(str(p))
