"""Serving quickstart on the PyTorch port: continuous-batching inference
over the pedestrian detector (the counterpart of
``examples/serve_cnn.py``).

  1. Build the pedestrian detector through ``InferenceSession`` on the
     ``"cuda"`` backend: its convolutions and pools run the hand-written
     Hopper kernels on the card (their plain versions on the CPU).
  2. Boot an ``InferenceServer`` on top: bounded queue, dynamic
     batching against a latency SLO, a CUDA stream a worker.
  3. Drive camera-frame traffic through it three ways: sync
     ``predict``, async futures, and a paced open-loop burst; then read
     the rolling stats and the kernels' launch counts.

Run:  PYTHONPATH=src python examples/serve_cnn_torch.py [--device cpu]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.configs.cnn_paper import pedestrian_classifier
from repro_torch.data.pipeline import camera_frame_batch
from repro_torch.engine import InferenceSession, SessionConfig
from repro_torch.kernels import conv2d, maxpool2d
from repro_torch.serve import (InferenceServer, RequestTimeout,
                               ServerConfig, ServerOverloaded)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="a torch device; default the card, cuda:0")
    args = ap.parse_args(argv)

    # ---------------------------------------------- 1. build the session
    graph = pedestrian_classifier(seed=0)
    sess = InferenceSession(graph, config=SessionConfig(
        backend="cuda", device=args.device))
    print(f"backend: {json.dumps(sess.backend.describe())}")
    frames = camera_frame_batch(64, tuple(graph.input_shape), seed=1)
    want = sess.predict(frames)

    # ------------------------------------------------- 2. boot a server
    # batch_deadline_ms is the aggregation SLO: a batch ships when it is
    # full OR its oldest request has waited this long.  max_queue bounds
    # memory; a full queue raises ServerOverloaded instead of hanging.
    server = InferenceServer(sess, config=ServerConfig(
        workers=2, max_batch=16, max_queue=1024,
        batch_deadline_ms=2.0, request_timeout_ms=1000.0))

    # ---------------------------------------------- 3a. sync convenience
    probs = server.predict(frames[0])
    np.testing.assert_allclose(probs, want[0], rtol=1e-5, atol=1e-6)
    print(f"sync predict -> {probs.shape}, argmax {int(np.argmax(probs))}")

    # -------------------------------------------------- 3b. async futures
    handles = [server.submit(f) for f in frames[:32]]
    outs = [h.result(timeout=5.0) for h in handles]
    np.testing.assert_allclose(np.stack(outs), want[:32], rtol=1e-5,
                               atol=1e-6)
    ts = handles[0].timestamps
    print(f"async x32: first request queued "
          f"{(ts['dequeue'] - ts['submit']) * 1e3:.2f} ms, "
          f"rode in a batch of {handles[0].batch_size}; equal to "
          f"predict: OK")

    # ------------------------------------ 3c. paced open-loop camera burst
    # 2000 frames at 4 kHz, arrivals on a clock, like a sensor;
    # backpressure (ServerOverloaded) and timeouts are counted, not
    # retried.
    rate_hz, n, dropped, timed_out, handles = 4000.0, 2000, 0, 0, []
    t0 = time.perf_counter()
    for i in range(n):
        target = t0 + i / rate_hz
        now = time.perf_counter()
        if target > now:
            time.sleep(target - now)
        try:
            handles.append(server.submit(frames[i % len(frames)]))
        except ServerOverloaded:
            dropped += 1
    for h in handles:
        try:
            h.result(timeout=5.0)
        except RequestTimeout:
            timed_out += 1

    stats = server.stats()
    print(f"open loop @ {rate_hz:.0f} Hz: {stats['completed']:.0f} served, "
          f"{dropped} dropped, {timed_out} timed out")
    print(f"  latency p50 {stats['latency_p50_us']:.0f} us | "
          f"p99 {stats['latency_p99_us']:.0f} us | "
          f"exec p50 {stats['exec_p50_us']:.0f} us")
    print(f"  throughput {stats['qps']:.0f} qps, "
          f"mean batch {stats['batch_size_mean']:.1f} "
          f"(occupancy {stats['batch_occupancy']:.2f})")

    server.close()          # graceful: drains queued work, joins workers
    print("server drained and closed")
    print("kernel launches: " + json.dumps(
        {"conv2d": conv2d.launches, "maxpool2d": maxpool2d.launches}))
    print("serve_cnn_torch: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
