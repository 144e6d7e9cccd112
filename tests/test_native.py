"""Native host runtime (hot_mpm.native): C++ writers/samplers vs the pure
fallbacks, and round-trips of the frame formats.

Reference parity: PartioIO .bgeo frames (#19), PlyIO (#17), mesh inside
sampling (#17), host counting sort. The native path must agree exactly
with the Python fallback so either can serve any run.
"""

import io as _io
import os

import numpy as np
import pytest

from hot_mpm import native
from hot_mpm.io.mesh import load_obj, points_inside_mesh


def test_native_builds():
    """The C++ toolchain is present in this image; the lib must build."""
    assert native.have_native(), "g++ build of hot_mpm/native/native.cpp failed"


def test_bgeo_roundtrip(tmp_path, rng):
    n = 1000
    x = rng.standard_normal((n, 3)).astype(np.float32)
    v = rng.standard_normal((n, 3)).astype(np.float32)
    p = str(tmp_path / "f.bgeo")
    native.write_bgeo(p, x, v)
    x2, v2 = native.read_bgeo(p)
    np.testing.assert_array_equal(x, x2)
    np.testing.assert_array_equal(v, v2)


def test_bgeo_native_matches_python_bytes(tmp_path, rng):
    if not native.have_native():
        pytest.skip("no native lib")
    n = 257
    x = rng.standard_normal((n, 3)).astype(np.float32)
    v = rng.standard_normal((n, 3)).astype(np.float32)
    p1 = str(tmp_path / "native.bgeo")
    p2 = str(tmp_path / "python.bgeo")
    native.write_bgeo(p1, x, v)
    native._write_bgeo_py(p2, x, v)
    assert open(p1, "rb").read() == open(p2, "rb").read()


def test_bgeo_header_shape(tmp_path):
    """Classic BGEO framing: magic, version 5, counts (big-endian)."""
    import struct

    x = np.zeros((3, 3), np.float32)
    p = str(tmp_path / "h.bgeo")
    native.write_bgeo(p, x)
    raw = open(p, "rb").read()
    assert raw[:5] == b"BgeoV"
    version, npts = struct.unpack(">ii", raw[5:13])
    assert version == 5 and npts == 3
    assert raw[-2:] == bytes([0x00, 0xFF])


def test_ply_roundtrip(tmp_path, rng):
    n = 64
    x = rng.standard_normal((n, 2)).astype(np.float32)  # 2D: padded to 3D
    p = str(tmp_path / "f.ply")
    native.write_ply(p, x)
    raw = open(p, "rb").read()
    header, _, body = raw.partition(b"end_header\n")
    assert b"element vertex 64" in header
    pts = np.frombuffer(body, "<f4").reshape(n, 3)
    np.testing.assert_allclose(pts[:, :2], x)
    np.testing.assert_array_equal(pts[:, 2], 0.0)


def _cube_obj(tmp_path):
    """Unit cube [0,1]^3 as an OBJ (12 triangles, watertight)."""
    verts = [(x, y, z) for x in (0, 1) for y in (0, 1) for z in (0, 1)]
    quads = [
        (0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
        (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3),
    ]
    lines = [f"v {x} {y} {z}" for (x, y, z) in verts]
    for q in quads:
        lines.append(f"f {q[0]+1} {q[1]+1} {q[2]+1}")
        lines.append(f"f {q[0]+1} {q[2]+1} {q[3]+1}")
    p = str(tmp_path / "cube.obj")
    with open(p, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return p


def test_inside_mesh_native_matches_python(tmp_path, rng):
    if not native.have_native():
        pytest.skip("no native lib")
    verts, faces = load_obj(_cube_obj(tmp_path))
    pts = rng.uniform(-0.3, 1.3, (500, 3))
    got = native.inside_mesh(verts, faces, pts)
    want = points_inside_mesh(pts, verts, faces)
    np.testing.assert_array_equal(got, want)
    # sanity on the geometry itself
    inside = (pts > 0).all(1) & (pts < 1).all(1)
    np.testing.assert_array_equal(got, inside)


def test_counting_sort(rng):
    n, n_cells = 5000, 64
    cells = rng.integers(0, n_cells, n).astype(np.int32)
    order, starts = native.counting_sort(cells, n_cells)
    sorted_cells = cells[order]
    assert (np.diff(sorted_cells) >= 0).all()
    # stable within equal keys
    for c in (0, 17, n_cells - 1):
        seg = order[starts[c]:starts[c + 1]]
        assert (cells[seg] == c).all()
        assert (np.diff(seg) > 0).all()
    assert starts[0] == 0 and starts[-1] == n
