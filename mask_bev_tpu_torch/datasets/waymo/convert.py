"""Waymo Open Dataset tfrecord -> converted .npz frames.

The port's copy of ``scripts/convert_waymo.py``, runnable as

  python -m mask_bev_tpu_torch.datasets.waymo.convert \\
      --input /data/waymo/training --output data/waymo/training \\
      [--max-frames N]

The reference converts Waymo offline via ``torch-waymo``
(``scripts/convert_waymo.sh`` -> ``torch_waymo convert``) and trains from the
converted frames (``waymo_data_module.py:48-85``). This writes the npz
schema that ``mask_bev_tpu_torch/datasets/waymo/waymo_data.py`` reads (and
the JAX package's loader too):

  points (N, 3) f32  box_center (M, 3) f32  box_dims (M, 3) f32 (l, w, h)
  box_heading (M,) f32  box_type (M,) i32  box_num_points (M,) i32

Decoding a tfrecord needs the ``waymo-open-dataset`` SDK and tensorflow,
optional heavy dependencies that training does not need; they are imported
only when a record is converted, and their absence ends the run with a
message. The frame decoding (TOP lidar, first return, vehicle-frame points)
follows the Waymo SDK's documented pipeline. The npz mapping,
:func:`extract_frame_arrays`, is pure; it and the ``.npz`` round trip are
what the tests hold (against ``scripts/convert_waymo.py``, with duck-typed
labels). The SDK path itself is not run by any test.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np


def extract_frame_arrays(points_xyz: np.ndarray, labels) -> dict:
    """Pure mapping: vehicle-frame TOP-lidar points + laser labels -> npz
    dict per the documented schema. ``labels`` are duck-typed Waymo laser
    labels: .box.{center_x,center_y,center_z,length,width,height,heading},
    .type, .num_lidar_points_in_box."""
    m = len(labels)
    center = np.zeros((m, 3), np.float32)
    dims = np.zeros((m, 3), np.float32)
    heading = np.zeros((m,), np.float32)
    btype = np.zeros((m,), np.int32)
    npts = np.zeros((m,), np.int32)
    for i, lab in enumerate(labels):
        b = lab.box
        center[i] = (b.center_x, b.center_y, b.center_z)
        dims[i] = (b.length, b.width, b.height)
        heading[i] = b.heading
        btype[i] = int(lab.type)
        npts[i] = int(lab.num_lidar_points_in_box)
    return dict(
        points=np.asarray(points_xyz, np.float32).reshape(-1, 3),
        box_center=center, box_dims=dims, box_heading=heading,
        box_type=btype, box_num_points=npts)


def convert_record(path: pathlib.Path, out_dir: pathlib.Path,
                   start_index: int, max_frames: int | None) -> int:
    """Decode one tfrecord with the Waymo SDK; returns frames written."""
    try:
        import tensorflow as tf
        from waymo_open_dataset import dataset_pb2
        from waymo_open_dataset.utils import frame_utils
    except ImportError as e:  # pragma: no cover - env without the SDK
        raise SystemExit(
            "mask_bev_tpu_torch.datasets.waymo.convert needs the optional "
            "'waymo-open-dataset' SDK and tensorflow (offline conversion "
            f"only): {e}")

    written = 0
    ds = tf.data.TFRecordDataset(str(path), compression_type="")
    for rec in ds:
        if max_frames is not None and written >= max_frames:
            break
        frame = dataset_pb2.Frame()
        frame.ParseFromString(bytearray(rec.numpy()))
        (range_images, camera_projections, _, range_image_top_pose) = (
            frame_utils.parse_range_image_and_camera_projection(frame))
        points, _ = frame_utils.convert_range_image_to_point_cloud(
            frame, range_images, camera_projections, range_image_top_pose,
            ri_index=0)  # first return
        # points is a list ordered by laser enum; TOP = 1 -> index 0
        top_points = points[0]
        arrays = extract_frame_arrays(top_points, list(frame.laser_labels))
        np.savez_compressed(
            out_dir / f"{start_index + written:08d}.npz", **arrays)
        written += 1
    return written


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True,
                    help="directory of *.tfrecord segments (one split)")
    ap.add_argument("--output", required=True,
                    help="output split directory for *.npz frames")
    ap.add_argument("--max-frames", type=int, default=None)
    args = ap.parse_args(argv)

    in_dir = pathlib.Path(args.input).expanduser()
    out_dir = pathlib.Path(args.output).expanduser()
    out_dir.mkdir(parents=True, exist_ok=True)
    records = sorted(in_dir.glob("*.tfrecord*"))
    if not records:
        print(f"no tfrecords under {in_dir}", file=sys.stderr)
        return 1
    total = 0
    for rec in records:
        budget = None if args.max_frames is None else args.max_frames - total
        if budget is not None and budget <= 0:
            break
        n = convert_record(rec, out_dir, total, budget)
        total += n
        print(f"{rec.name}: +{n} frames (total {total})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
