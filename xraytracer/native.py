"""ctypes bindings for the native C++ IO tier (native/xrt_native.cpp).

Where the reference's runtime is native C++ (tinyObjLoader scene loading,
Src/scene.cpp:46-155; OpenCV image export, Src/image.h:116-143), this
framework keeps the same split: JAX owns the compute path, and the
IO tier (OBJ/MTL parsing, PNG/PPM encoding) is a C++ shared library built
on first use with g++ (no pybind11 in the image — plain C ABI + ctypes).

Everything degrades gracefully: if the toolchain or library is missing
(``XRT_NO_NATIVE=1`` also forces it), callers fall back to the pure-Python
implementations in scene/objloader.py and film.py.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np

_LIB = None
_TRIED = False

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "native", "xrt_native.cpp")
_SO = os.path.join(os.path.dirname(_SRC), "libxrt_native.so")


def _build():
    cmd = [
        "g++", "-O2", "-shared", "-fPIC", "-std=c++17",
        "-o", _SO, _SRC, "-lz",
    ]
    subprocess.run(cmd, check=True, capture_output=True)


def _bind(lib):
    c_char_p = ctypes.c_char_p
    c_int = ctypes.c_int
    c_void_p = ctypes.c_void_p
    c_float_p = ctypes.POINTER(ctypes.c_float)

    lib.xrt_parse_obj.restype = c_void_p
    lib.xrt_parse_obj.argtypes = [c_char_p]
    lib.xrt_free_obj.argtypes = [c_void_p]
    lib.xrt_obj_error.restype = c_char_p
    lib.xrt_obj_error.argtypes = [c_void_p]
    lib.xrt_obj_num_shapes.restype = c_int
    lib.xrt_obj_num_shapes.argtypes = [c_void_p]
    lib.xrt_obj_shape_name.restype = c_char_p
    lib.xrt_obj_shape_name.argtypes = [c_void_p, c_int]
    lib.xrt_obj_shape_material.restype = c_char_p
    lib.xrt_obj_shape_material.argtypes = [c_void_p, c_int]
    lib.xrt_obj_shape_tri_count.restype = c_int
    lib.xrt_obj_shape_tri_count.argtypes = [c_void_p, c_int]
    for fn in ("xrt_obj_shape_vertices", "xrt_obj_shape_normals",
               "xrt_obj_shape_uvs"):
        getattr(lib, fn).restype = c_float_p
        getattr(lib, fn).argtypes = [c_void_p, c_int]
    lib.xrt_obj_num_materials.restype = c_int
    lib.xrt_obj_num_materials.argtypes = [c_void_p]
    lib.xrt_obj_material_name.restype = c_char_p
    lib.xrt_obj_material_name.argtypes = [c_void_p, c_int]
    lib.xrt_obj_material_props.argtypes = [
        c_void_p, c_int, c_float_p, c_float_p,
        c_float_p, ctypes.POINTER(c_int), ctypes.POINTER(c_int),
    ]
    lib.xrt_write_png.restype = c_int
    lib.xrt_write_png.argtypes = [c_char_p, ctypes.c_char_p, c_int, c_int]
    lib.xrt_write_ppm.restype = c_int
    lib.xrt_write_ppm.argtypes = [c_char_p, ctypes.c_char_p, c_int, c_int]
    return lib


def get_lib():
    """The loaded native library, building it if needed; None when
    unavailable (caller falls back to Python)."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("XRT_NO_NATIVE"):
        return None
    try:
        if (not os.path.exists(_SO)
                or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            _build()
        _LIB = _bind(ctypes.CDLL(_SO))
    except Exception as e:  # toolchain/library missing: pure-Python fallback
        print(f"[xrt_native] falling back to Python IO ({e})", file=sys.stderr)
        _LIB = None
    return _LIB


def parse_obj(path):
    """Native OBJ parse with the same return contract as
    ``scene.objloader.parse_obj``; None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    handle = lib.xrt_parse_obj(str(path).encode())
    if not handle:
        raise FileNotFoundError(path)
    try:
        err = lib.xrt_obj_error(handle).decode()
        if err:
            # fail like the Python parser does on a bad face index
            raise IndexError(err)
        shapes = []
        for i in range(lib.xrt_obj_num_shapes(handle)):
            t = lib.xrt_obj_shape_tri_count(handle, i)
            verts = np.ctypeslib.as_array(
                lib.xrt_obj_shape_vertices(handle, i), shape=(t, 3, 3)
            ).copy()
            nptr = lib.xrt_obj_shape_normals(handle, i)
            norms = (
                np.ctypeslib.as_array(nptr, shape=(t, 3, 3)).copy()
                if nptr else None
            )
            tptr = lib.xrt_obj_shape_uvs(handle, i)
            uvs = (
                np.ctypeslib.as_array(tptr, shape=(t, 3, 2)).copy()
                if tptr else None
            )
            mat = lib.xrt_obj_shape_material(handle, i).decode()
            shapes.append(
                {
                    "name": lib.xrt_obj_shape_name(handle, i).decode(),
                    "material": mat or None,
                    "vertices": verts,
                    "normals": norms,
                    "uvs": uvs,
                }
            )
        materials = {}
        kd = (ctypes.c_float * 3)()
        ke = (ctypes.c_float * 3)()
        ni = ctypes.c_float()
        illum = ctypes.c_int()
        nos = ctypes.c_int()
        for i in range(lib.xrt_obj_num_materials(handle)):
            name = lib.xrt_obj_material_name(handle, i).decode()
            lib.xrt_obj_material_props(
                handle, i, kd, ke, ctypes.byref(ni),
                ctypes.byref(illum), ctypes.byref(nos),
            )
            materials[name] = {
                "Kd": tuple(kd),
                "Ke": tuple(ke),
                "Ni": float(ni.value),
                "illum": int(illum.value),
                "no_surface": bool(nos.value),
            }
        return shapes, materials
    finally:
        lib.xrt_free_obj(handle)


def write_png(path, img_u8):
    """Native PNG encode; False when unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    h, w, _ = img_u8.shape
    data = np.ascontiguousarray(img_u8, np.uint8)
    rc = lib.xrt_write_png(str(path).encode(), data.tobytes(), w, h)
    if rc != 0:
        raise IOError(f"xrt_write_png failed ({rc}) for {path}")
    return True


def write_ppm(path, img_u8):
    """Native binary-PPM (P6) encode; False when unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    h, w, _ = img_u8.shape
    data = np.ascontiguousarray(img_u8, np.uint8)
    rc = lib.xrt_write_ppm(str(path).encode(), data.tobytes(), w, h)
    if rc != 0:
        raise IOError(f"xrt_write_ppm failed ({rc}) for {path}")
    return True
