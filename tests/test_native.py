"""Native C++ IO tier vs. the pure-Python reference implementations."""

import os
import struct
import zlib

import numpy as np
import pytest

from xraytracer import native
from xraytracer.scene import objloader

OBJ = """\
mtllib test.mtl
o wall
usemtl red
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vn 0 0 1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
f 1/1/1 2/2/1 3/3/1 4/4/1
o bare
v 0 0 2
v 1 0 2
v 0 1 2
f -3 -2 -1
g empty_group
usemtl glassy
"""

MTL = """\
newmtl red
Kd 0.8 0.1 0.1
Ke 0 0 0
Ni 1.0
illum 2
newmtl glassy
Kd 1 1 1
Ni 1.45
illum 7
newmtl ghost
no_surface
"""


@pytest.fixture
def obj_file(tmp_path):
    (tmp_path / "test.mtl").write_text(MTL)
    p = tmp_path / "test.obj"
    p.write_text(OBJ)
    return str(p)


def test_native_matches_python_parser(obj_file):
    lib = native.get_lib()
    if lib is None:
        pytest.skip("native toolchain unavailable")
    py_shapes, py_mats = objloader.parse_obj(obj_file, use_native=False)
    nat_shapes, nat_mats = native.parse_obj(obj_file)
    assert len(nat_shapes) == len(py_shapes) == 2
    for a, b in zip(py_shapes, nat_shapes):
        assert a["name"] == b["name"]
        assert a["material"] == b["material"]
        np.testing.assert_allclose(a["vertices"], b["vertices"], rtol=1e-6)
        if a["normals"] is None:
            assert b["normals"] is None
        else:
            np.testing.assert_allclose(a["normals"], b["normals"], rtol=1e-6)
        if a["uvs"] is None:
            assert b["uvs"] is None
        else:
            np.testing.assert_allclose(a["uvs"], b["uvs"], rtol=1e-6)
    assert set(nat_mats) == set(py_mats)
    for k in py_mats:
        np.testing.assert_allclose(nat_mats[k]["Kd"], py_mats[k]["Kd"], rtol=1e-6)
        assert nat_mats[k]["illum"] == py_mats[k]["illum"]
        assert nat_mats[k]["no_surface"] == py_mats[k]["no_surface"]
        np.testing.assert_allclose(nat_mats[k]["Ni"], py_mats[k]["Ni"], rtol=1e-6)


def test_native_png_roundtrip(tmp_path):
    lib = native.get_lib()
    if lib is None:
        pytest.skip("native toolchain unavailable")
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (17, 23, 3)).astype(np.uint8)
    p = str(tmp_path / "x.png")
    assert native.write_png(p, img)
    data = open(p, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    # decode the IDAT ourselves and compare pixels
    off = 8
    idat = b""
    while off < len(data):
        (ln,) = struct.unpack(">I", data[off:off + 4])
        tag = data[off + 4:off + 8]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", data[off + 8:off + 18])
            assert (w, h, depth, ctype) == (23, 17, 8, 2)
        elif tag == b"IDAT":
            idat += data[off + 8:off + 8 + ln]
        off += 12 + ln
    raw = zlib.decompress(idat)
    rows = np.frombuffer(raw, np.uint8).reshape(17, 1 + 23 * 3)
    assert (rows[:, 0] == 0).all()  # filter byte
    np.testing.assert_array_equal(rows[:, 1:].reshape(17, 23, 3), img)


def test_native_ppm(tmp_path):
    lib = native.get_lib()
    if lib is None:
        pytest.skip("native toolchain unavailable")
    img = np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3)
    p = str(tmp_path / "x.ppm")
    assert native.write_ppm(p, img)
    data = open(p, "rb").read()
    assert data.startswith(b"P6\n3 2\n255\n")
    assert data[len(b"P6\n3 2\n255\n"):] == img.tobytes()


def test_cornell_obj_via_builder(tmp_path):
    """End-to-end: an OBJ through load_obj_into produces a renderable
    scene whichever parser ran."""
    (tmp_path / "test.mtl").write_text(MTL)
    p = tmp_path / "scene.obj"
    p.write_text(OBJ)
    from xraytracer.scene.builder import SceneBuilder

    b = SceneBuilder()
    objloader.load_obj_into(b, str(p))
    tables = b.build()
    assert int((np.asarray(tables.tri_obj) >= 0).sum()) == 3  # 2 + 1 tris


def test_emissive_from_ke(tmp_path):
    """Shapes with Ke become triangle lights when opted in (the reference's
    dead makeAreaLight, Src/scene.cpp:31-44, made live)."""
    (tmp_path / "m.mtl").write_text(
        "newmtl lamp\nKd 1 1 1\nKe 5 4 3\nnewmtl wall\nKd 0.5 0.5 0.5\n"
    )
    (tmp_path / "s.obj").write_text(
        "mtllib m.mtl\no lamp\nusemtl lamp\n"
        "v 0 2 0\nv 1 2 0\nv 0 2 1\nf 1 2 3\n"
        "o wall\nusemtl wall\nv 0 0 0\nv 1 0 0\nv 0 0 1\nf 4 5 6\n"
    )
    from xraytracer.scene.builder import SceneBuilder

    b = SceneBuilder()
    objloader.load_obj_into(b, str(tmp_path / "s.obj"), emissive_from_ke=True)
    t = b.build()
    assert int((np.asarray(t.al_type) >= 0).sum()) == 1
    np.testing.assert_allclose(np.asarray(t.al_le)[0], [5, 4, 3])
    # the wall is still a plain lambert mesh
    assert int((np.asarray(t.tri_obj) >= 0).sum()) == 2


@pytest.mark.parametrize("face", ["f 1 2 99", "f 0 2 3", "f 1/9/1 2/1/1 3/1/1"])
def test_invalid_face_index_fails_identically(tmp_path, face):
    """A malformed face token must raise IndexError from BOTH parsers
    instead of reading out of bounds in C++ (round-1 ADVICE item 2)."""
    p = tmp_path / "bad.obj"
    p.write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\n"
        "vt 0 0\nvn 0 0 1\n" + face + "\n"
    )
    with pytest.raises(IndexError):
        objloader.parse_obj(str(p), use_native=False)
    if native.get_lib() is not None:
        with pytest.raises(IndexError):
            native.parse_obj(str(p))
