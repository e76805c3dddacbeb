"""End-to-end CLI coverage (the L8 surface replacing the reference's five
hard-coded mains, SURVEY.md §2.3): argument plumbing, preset dispatch,
image output, and checkpoint --resume continuation."""

import os

import numpy as np

from xraytracer.cli import main


def _decode_png(path):
    """Minimal PNG decode (mirrors tests/test_native.py's approach)."""
    import struct
    import zlib

    raw = open(path, "rb").read()
    assert raw[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(raw):
        ln, typ = struct.unpack(">I4s", raw[pos:pos + 8])
        pos += 8
        data = raw[pos:pos + ln]
        pos += ln + 4
        if typ == b"IHDR":
            w, h = struct.unpack(">II", data[:8])
        elif typ == b"IDAT":
            idat += data
    rows = np.frombuffer(zlib.decompress(idat), np.uint8)
    rows = rows.reshape(h, 3 * w + 1)
    assert (rows[:, 0] == 0).all()  # filter type 0 (the writer's choice)
    return rows[:, 1:].reshape(h, w, 3)


def test_cli_render_writes_decodable_png(tmp_path):
    out = os.path.join(tmp_path, "out.png")
    rc = main([
        "--preset", "cornellbox_gi", "--width", "32", "--height", "24",
        "--spp", "2", "-o", out,
    ])
    assert rc in (0, None)
    img = _decode_png(out)
    assert img.shape == (24, 32, 3)
    assert img.mean() > 1.0 and (img > 0).mean() > 0.2


def test_cli_resume_continues_accumulation(tmp_path):
    ckpt = os.path.join(tmp_path, "acc.npz")
    out1 = os.path.join(tmp_path, "a.png")
    out2 = os.path.join(tmp_path, "b.png")
    full = os.path.join(tmp_path, "full.png")
    common = ["--preset", "cornellbox_gi", "--width", "32", "--height", "24",
              "--seed", "4"]
    main(common + ["--spp", "2", "--checkpoint", ckpt, "-o", out1])
    # resume to 4 spp: must continue the per-pixel streams at sample 2
    main(common + ["--spp", "4", "--checkpoint", ckpt, "--resume",
                   "-o", out2])
    main(common + ["--spp", "4", "-o", full])
    np.testing.assert_array_equal(_decode_png(out2), _decode_png(full))
