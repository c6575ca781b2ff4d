"""Command-line entry points of the port (the C++ reference's example binaries).

The port's counterpart of movslam_tpu/cli.py, after the C++ reference's
Examples/Monocular/mono_video_tartan.cc and Examples/Stereo/
stereo_video_tartan.cc: `<settings.yaml> <stream>` in;
TrajectoryKITTIKeyFrame.txt, TrajectoryEUROC.txt and results.txt
(`imageCnt,totalLost,avg_ms`, mono_video_tartan.cc:105-115) out, in the
working directory.

    python -m movslam_tpu_torch.cli mono <settings.yaml> <stream> [--realtime] [--imu] [--viewer DIR] [--cpu]
    python -m movslam_tpu_torch.cli stereo <settings.yaml> <stream> [--realtime] [--viewer DIR] [--cpu]

Stream forms:
  synthetic://n_frames=N,seed=S[,n_points=P]        ground-truth fake decoder
  synthetic-stereo://n_frames=N,seed=S[,baseline_mm=B]
  synthetic-vi://n_frames=N,seed=S                  fake decoder + analytic IMU
  <path.mp4 | .ts | tcp://host:port>                native FFmpeg decoder (io/video.py)

Everything runs on the CUDA card, and raises without one; `--cpu` runs on
the CPU instead. Reading <settings.yaml> needs pyyaml. A caller without it
builds `Settings` in code and calls `mono_drive` / `stereo_drive` with a
System, then `_finish`, as `mono_main` does.

--realtime paces one frame per 1/fps with per-frame calls
(mono_video_tartan.cc:73-93); without it the drive is the throughput one:
W-frame batches with windows kept in flight across calls (flush=False) and
one final flush=True.

--viewer DIR streams annotated frame PNGs (frame_NNNNNN.png: green trails
= track history, green boxes = map-point inliers) into DIR through the
headless viewer (viz/viewer.py). It draws with cv2; a host without cv2
writes none and says so.
"""
from __future__ import annotations

import sys
import time

from .config.settings import IMU_MONOCULAR, MONOCULAR, STEREO

USAGE = {
    "mono": "<settings.yaml> <stream> [--realtime] [--imu] [--viewer DIR] [--cpu]",
    "stereo": "<settings.yaml> <stream> [--realtime] [--viewer DIR] [--cpu]",
}
SETTINGS_NOTE = "(<settings.yaml> is read with pyyaml; without it, build Settings in code and call mono_drive)"


def _synthetic_kwargs(url, scheme):
    kwargs = {}
    for kv in url[len(scheme):].split(","):
        if kv:
            k, v = kv.split("=")
            kwargs[k] = int(v)
    return kwargs


def _video_decoder(url):
    from .io.video import VideoDecoder

    dec = VideoDecoder(url, qlen=12)
    dec.init()
    return dec


def open_stream(url, fps_hint=30.0):
    """Mono stream: (iterator of MotionVectorImage, frame count or None)."""
    if url.startswith("synthetic://"):
        from .io.synthetic import SyntheticStream

        kwargs = _synthetic_kwargs(url, "synthetic://")
        n_frames = kwargs.pop("n_frames", 300)
        return SyntheticStream(fps=fps_hint, **kwargs).frames(n_frames), n_frames
    return iter(_video_decoder(url)), None


def open_vi_stream(url, fps_hint=30.0):
    """Visual-inertial stream: ((ts, smv, imu) triples, frame count). Only
    `synthetic-vi://`: real capture needs a time-aligned IMU sidecar."""
    if not url.startswith("synthetic-vi://"):
        raise SystemExit("IMU_MONOCULAR streams: synthetic-vi://n_frames=N,seed=S "
                         "(real capture needs a time-aligned IMU sidecar)")
    from .io.synthetic_vi import SyntheticVIStream

    kwargs = _synthetic_kwargs(url, "synthetic-vi://")
    n_frames = kwargs.pop("n_frames", 300)
    return SyntheticVIStream(fps=fps_hint, **kwargs).items(n_frames), n_frames


def open_stereo_stream(url, fps_hint=30.0):
    """Stereo stream: (left, right) MotionVectorImage pairs. A video holds
    them frame-packed, left then right; right frames skip the MV copies
    (stereo_video_tartan.cc:74-99)."""
    if url.startswith("synthetic-stereo://"):
        from .io.synthetic_stereo import SyntheticStereoStream

        kwargs = _synthetic_kwargs(url, "synthetic-stereo://")
        n_frames = kwargs.pop("n_frames", 200)
        b = kwargs.pop("baseline_mm", 250) / 1000.0
        return SyntheticStereoStream(fps=fps_hint, baseline=b, **kwargs).pairs(n_frames)
    dec = _video_decoder(url)

    def pairs():
        while True:
            left = dec.next_image(True)
            if left is None:
                return
            right = dec.next_image(False)
            if right is None:
                return
            yield left, right

    return pairs()


def _paced(slam, items, track):
    """Per-frame calls, one per 1/fps budget."""
    fps = slam.get_fps()
    n = 0
    for it in items:
        t0 = time.perf_counter()
        track(*it)
        n += 1
        budget = 1.0 / fps - (time.perf_counter() - t0)
        if budget > 0:
            time.sleep(budget)
    return n


def _batched(slam, items, track_batch):
    """Throughput drive: W-frame batches with flush=False, so the pipelined
    drive keeps windows in flight across calls; one final flush=True."""
    n, batch = 0, []
    for it in items:
        batch.append(it)
        if len(batch) >= slam.window:
            track_batch(batch, flush=False)
            n += len(batch)
            batch = []
    track_batch(batch, flush=True)
    return n + len(batch)


def mono_drive(slam, url, realtime=False):
    """Drive a MONOCULAR or IMU_MONOCULAR System over `url`. Returns
    (frames fed, wall seconds)."""
    if slam.sensor == IMU_MONOCULAR:
        items, _ = open_vi_stream(url, slam.get_fps())
    else:
        frames, _ = open_stream(url, slam.get_fps())
        items = ((smv.timestamp, smv) for smv in frames if smv is not None)
    t0 = time.perf_counter()
    if realtime:
        n = _paced(slam, items, slam.track_monocular)
    else:
        n = _batched(slam, items, slam.track_monocular_batch)
    return n, time.perf_counter() - t0


def stereo_drive(slam, url, realtime=False):
    """Drive a STEREO System over `url`. Returns (pairs fed, wall seconds)."""
    items = ((left.timestamp, left, right) for left, right in open_stereo_stream(url, slam.get_fps()))
    t0 = time.perf_counter()
    if realtime:
        n = _paced(slam, items, slam.track_stereo)
    else:
        n = _batched(slam, items, slam.track_stereo_batch)
    return n, time.perf_counter() - t0


def _finish(slam, n, wall):
    """Shut down and write the two trajectories and results.txt."""
    slam.shutdown()
    slam.save_keyframe_trajectory_kitti("TrajectoryKITTIKeyFrame.txt")
    slam.save_trajectory_euroc("TrajectoryEUROC.txt")
    with open("results.txt", "w") as f:
        f.write(f"{slam.image_count},{slam.get_total_lost()},{slam.mean_track_ms():.6f}\n")
    print(f"frames={n} lost={slam.get_total_lost()} mean_track_ms={slam.mean_track_ms():.2f} "
          f"wall_fps={n / max(wall, 1e-9):.1f}")
    return 0


def _device(argv):
    return "cpu" if "--cpu" in argv else "cuda"


def _system(argv, sensor):
    """The System of `argv` ([program, settings.yaml, stream, flags...]),
    with the viewer writing to --viewer's directory when one is given."""
    from .core.system import System

    viewer_dir = argv[argv.index("--viewer") + 1] if "--viewer" in argv else None
    slam = System(argv[1], sensor, device=_device(argv), use_viewer=viewer_dir is not None)
    if viewer_dir is not None:
        slam.viewer.out_dir = viewer_dir
    return slam


def mono_main(argv=None):
    """`argv` as sys.argv: [program, settings.yaml, stream, flags...]."""
    argv = list(sys.argv if argv is None else argv)
    if len(argv) < 3:
        print(f"Usage: {argv[0] if argv else 'mono'} {USAGE['mono']}\n{SETTINGS_NOTE}")
        return 1
    url = argv[2]
    use_imu = "--imu" in argv or url.startswith("synthetic-vi://")
    slam = _system(argv, IMU_MONOCULAR if use_imu else MONOCULAR)
    n, wall = mono_drive(slam, url, realtime="--realtime" in argv)
    return _finish(slam, n, wall)


def stereo_main(argv=None):
    """`argv` as sys.argv: [program, settings.yaml, stream, flags...]."""
    argv = list(sys.argv if argv is None else argv)
    if len(argv) < 3:
        print(f"Usage: {argv[0] if argv else 'stereo'} {USAGE['stereo']}\n{SETTINGS_NOTE}")
        return 1
    slam = _system(argv, STEREO)
    n, wall = stereo_drive(slam, argv[2], realtime="--realtime" in argv)
    return _finish(slam, n, wall)


def main(argv=None):
    argv = list(sys.argv if argv is None else argv)
    mains = {"mono": mono_main, "stereo": stereo_main}
    if len(argv) < 2 or argv[1] not in mains:
        print("Usage: python -m movslam_tpu_torch.cli mono|stereo ...\n"
              + "\n".join(f"  {k} {v}" for k, v in USAGE.items()) + f"\n{SETTINGS_NOTE}")
        return 1
    return mains[argv[1]]([f"{argv[0]} {argv[1]}"] + argv[2:])


if __name__ == "__main__":
    sys.exit(main())
