"""The port of tests/test_tcp_ingest.py: the port's VideoDecoder on a live
MPEG-TS stream over a loopback TCP socket (the C++ reference's deployment
mode, VideoDecoder.cc:54), with a real x264 stream."""
import socket
import threading

import numpy as np
import pytest

from movslam_tpu_torch.io.synthetic import SyntheticStream
from movslam_tpu_torch.io.video import VideoDecoder, encode_gray


@pytest.mark.slow
def test_tcp_mpegts_ingest(tmp_path):
    N = 80
    stream = SyntheticStream(n_points=300, seed=13)
    path = str(tmp_path / "stream.ts")  # the extension picks the MPEG-TS muxer
    encode_gray(path, np.stack([stream.render(k)[0] for k in range(N)]), fps=30.0, keyint=1000,
                refs=2, cavlc=True)
    payload = open(path, "rb").read()
    assert len(payload) > 50000 and payload[0] == 0x47 and payload[188] == 0x47

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]

    def serve():
        conn, _ = srv.accept()
        try:
            for off in range(0, len(payload), 32 * 188):  # chunks, like a live encoder
                conn.sendall(payload[off:off + 32 * 188])
        finally:
            conn.close()
            srv.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    dec = VideoDecoder(f"tcp://127.0.0.1:{port}", qlen=12)
    dec.init()
    n_frames = n_p_with_mvs = 0
    while True:
        smv = dec.next_image(True)
        if smv is None:
            break
        n_frames += 1
        assert smv.im_gray.shape == (480, 640)
        if smv.ft == 1 and smv.n_mvs > 100:
            n_p_with_mvs += 1
    t.join(timeout=10)
    assert n_frames >= N - 13, n_frames
    assert n_p_with_mvs >= n_frames - 5, (n_p_with_mvs, n_frames)
