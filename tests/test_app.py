"""App shell + calibration-file parsing tests."""

import numpy as np
import pytest

from rgbd_recon.calib.kinect_yml import parse_kinect_yml

YML = """%YAML:1.0
rgb_intrinsics: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [ 1050.5, 0., 640.25, 0., 1052.75, 540.5, 0., 0., 1. ]
rgb_distortion: !!opencv-matrix
   data: [ 1.0e-02, -2.0e-02, 3.0e-04, -4.0e-04, 5.0e-03 ]
depth_intrinsics: !!opencv-matrix
   data: [ 365.5, 0., 256.0, 0., 365.75, 212.0, 0., 0., 1. ]
depth_distortion: !!opencv-matrix
   data: [ 9.0e-02, -2.5e-01, 1.0e-03, -1.5e-03, 9.0e-02 ]
R: !!opencv-matrix
   data: [ 0.9999, -0.0059, 0.0101, 0.0060, 0.9999, -0.0093, -0.0101,
       0.0094, 0.9999 ]
T: !!opencv-matrix
   data: [ -5.20e-02, -6.3e-04, -8.0e-04 ]
rgb_size: !!opencv-matrix
   data: [ 1280., 1080. ]
depth_size: !!opencv-matrix
   data: [ 512., 424. ]
near_far: !!opencv-matrix
   data: [ 0.5, 4.5 ]
compress_rgb: !!opencv-matrix
   data: [ 5., 0. ]
compress_depth: !!opencv-matrix
   data: [ 1., 0. ]
min_length: !!opencv-matrix
   data: [ 0.018, 0. ]
"""


def test_parse_kinect_yml(tmp_path):
    p = tmp_path / "23.yml"
    p.write_text(YML)
    (tmp_path / "23.ext").write_text(
        "0.5 1.0 -0.25\n"
        "1 0 0\n0 0 -1\n0 1 0\n"
    )
    (tmp_path / "23.serial").write_text("012345678947\n")

    cal = parse_kinect_yml(p)
    assert cal.intrinsics_rgb[0, 0] == 1050.5
    assert cal.intrinsics_rgb[1, 2] == 540.5
    assert cal.intrinsics_depth[0, 0] == 365.5
    np.testing.assert_allclose(cal.distortion_depth,
                               [0.09, -0.25, 0.001, -0.0015, 0.09])
    np.testing.assert_allclose(cal.relative_translation,
                               [-0.052, -0.00063, -0.0008])
    assert cal.relative_rotation.shape == (3, 3)
    assert cal.rgb_size == (1280, 1080)
    assert cal.depth_size == (512, 424)
    assert cal.near == 0.5 and cal.far == 4.5
    assert cal.compressed_rgb == 5
    assert cal.compressed_depth is True
    assert cal.min_length == 0.018
    np.testing.assert_allclose(cal.world_translation, [0.5, 1.0, -0.25])
    np.testing.assert_allclose(
        cal.world_rotation, [[1, 0, 0], [0, 0, -1], [0, 1, 0]]
    )
    assert cal.serial == "012345678947"

    sensor = cal.to_rgbd_sensor()
    assert sensor.depth.width == 512
    assert sensor.color.width == 1280
    np.testing.assert_allclose(sensor.depth.position, [0.5, 1.0, -0.25])
    assert sensor.serial == "012345678947"


def test_app_record_and_run(tmp_path):
    """Full CLI round trip at tiny scale: record .streams, then reconstruct
    from them (the reference's readfromfile workflow)."""
    from rgbd_recon.app import main

    rec = tmp_path / "rec"
    main([
        "record", "--out", str(rec), "--frames", "2", "--sensors", "2",
        "--depth-size", "40", "32", "--color-size", "48", "40",
    ])
    streams = sorted(rec.glob("*.stream"))
    assert len(streams) == 2

    scene = tmp_path / "scene.ks"
    scene.write_text("kinect a.yml\nkinect b.yml\nbbx -1 0 -1 1 2.2 1\n")
    conf = tmp_path / "s.conf"
    conf.write_text(
        "voxel_size: 0.1\nbrick_size: 0.5\ntsdf_limit: 0.02\nrecon_mode: 1\n"
    )
    out = tmp_path / "out"
    main([
        "run", str(scene), "--conf", str(conf), "--streams", str(rec),
        "--frames", "2", "--out", str(out), "--width", "48", "--height", "40",
        "--depth-size", "40", "32", "--color-size", "48", "40",
        "--inv-res", "24", "26", "24",
    ])
    assert (out / "timings.csv").exists()
    renders = sorted(out.glob("frame_*.png"))
    assert len(renders) == 2


def test_app_invert(tmp_path):
    """CLI inverse-calibration baking on a baked cv_xyz file."""
    from rgbd_recon.app import main
    from rgbd_recon.calib.bake import bake_cv_xyz
    from rgbd_recon.calib.volume_io import (
        read_calibration_volume,
        write_calibration_volume,
    )
    from rgbd_recon.core.grid import BoundingBox
    from rgbd_recon.sensors.synthetic import default_test_rig

    bbox = BoundingBox(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))
    rig = default_test_rig(num_sensors=1, bbox=bbox)
    cv = bake_cv_xyz(rig.sensors[0], res=(16, 20, 16))
    write_calibration_volume(tmp_path / "23.cv_xyz", cv, (0.5, 4.5))
    scene = tmp_path / "scene.ks"
    scene.write_text("kinect 23.yml\nbbx -1 0 -1 1 2.2 1\n")

    main(["invert", str(scene), "--voxel-size", "0.25", "--out", str(tmp_path)])
    inv, limits = read_calibration_volume(tmp_path / "23.cv_xyz_inv", channels=4)
    assert inv.shape == (8, 9, 8, 4)  # (Z, Y=ceil(2.2/0.25), X, 4)
    assert (inv[..., 3] > 0).any()


def test_app_run_stereo_checkpoint(tmp_path):
    """CLI: anaglyph stereo output + rotating checkpoints at tiny scale."""
    from rgbd_recon.app import main

    scene = tmp_path / "scene.ks"
    scene.write_text("kinect a.yml\nkinect b.yml\nbbx -1 0 -1 1 2.2 1\n")
    conf = tmp_path / "s.conf"
    conf.write_text(
        "voxel_size: 0.1\nbrick_size: 0.5\ntsdf_limit: 0.02\nrecon_mode: 1\n"
    )
    out = tmp_path / "out"
    ck = tmp_path / "ck"
    main([
        "run", str(scene), "--conf", str(conf),
        "--frames", "2", "--out", str(out), "--width", "48", "--height", "40",
        "--depth-size", "40", "32", "--color-size", "48", "40",
        "--inv-res", "24", "26", "24",
        "--stereo", "anaglyph",
        "--checkpoint-dir", str(ck), "--checkpoint-every", "1",
    ])
    from rgbd_recon.viz import load_image

    renders = sorted(out.glob("frame_*.png"))
    assert len(renders) == 2
    img = load_image(renders[0])
    assert img.shape == (40, 48, 3)  # anaglyph composes into one frame

    from rgbd_recon.io import CheckpointManager

    latest = CheckpointManager(ck).latest()
    assert latest is not None and latest.frame_index == 2


def test_preview_server_streams_frames():
    """Live MJPEG preview: update() publishes frames that /frame and
    /stream serve (the reference viewer's headless stand-in)."""
    import urllib.request

    import numpy as np

    from rgbd_recon.viz.preview import PreviewServer

    srv = PreviewServer(port=0)  # ephemeral port
    try:
        img = np.zeros((24, 32, 3), np.float32)
        img[:, :16] = (1.0, 0.2, 0.1)
        srv.update(img)
        with urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/frame", timeout=5
        ) as r:
            data = r.read()
        assert data[:2] == b"\xff\xd8"  # JPEG SOI
        with urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/", timeout=5
        ) as r:
            assert b"/stream" in r.read()
        # the stream endpoint delivers at least one multipart frame
        req = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/stream", timeout=5
        )
        chunk = req.read(64)
        assert b"--f" in chunk and b"image/jpeg" in chunk
        req.close()
    finally:
        srv.close()


@pytest.mark.parametrize("kind", ["float_rgb", "uint8_gray"])
def test_png_writer_round_trip(tmp_path, kind):
    """viz.save_image writes a valid 8-bit RGB PNG with the standard
    library; load_image reads back exactly the quantized pixels."""
    import struct
    import zlib

    from rgbd_recon.viz import load_image, save_image

    rng = np.random.default_rng(7)
    if kind == "float_rgb":
        img = rng.random((9, 13, 3)).astype(np.float32)
        img[0, 0] = (-0.5, 1.5, 1.0)  # clipped to [0, 1]
        want = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    else:
        img = rng.integers(0, 256, (6, 11), dtype=np.uint8)
        want = np.stack([img] * 3, axis=-1)
    p = tmp_path / "x.png"
    save_image(p, img)
    data = p.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    # every chunk's CRC is valid and IHDR says 8-bit RGB
    pos, tags = 8, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        body = data[pos + 4:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert zlib.crc32(body) & 0xFFFFFFFF == crc
        tags.append(body[:4])
        pos += 12 + n
    assert tags[0] == b"IHDR" and tags[-1] == b"IEND"
    h, w = want.shape[:2]
    assert struct.unpack(">IIBB", data[16:26]) == (w, h, 8, 2)
    np.testing.assert_array_equal(load_image(p), want)
