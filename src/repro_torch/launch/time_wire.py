"""Time one frame of the procs backend's wire: a tensor of ``--mb`` MB
pickled into a frame (``Message.to_wire`` and the length prefix), sent
over a Unix socket pair and received, then unpickled, with the port's
``_recv_exact`` (into one buffer) and with the original's receive loop
(``recv`` of all that is left, once a chunk).  An operator's tool: it
shows what a full-width model's footprint costs a task on this host.

    PYTHONPATH=src python -m repro_torch.launch.time_wire --mb 256
"""

from __future__ import annotations

import argparse
import json
import socket
import threading
import time

import torch

from repro_torch.core.backend_procs import _LEN, _frame_bytes, _recv_exact
from repro_torch.core.substrate import Message


def _recv_by_chunks(sock: socket.socket, n: int) -> bytes | None:
    """``repro.core.backend_procs._recv_exact``: each ``recv`` asks for
    all that is left, so it allocates that many bytes a chunk."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def time_frame(mb: int, name: str, receive) -> dict:
    """Seconds to build, move and unpickle one frame of an ``mb`` MB f32
    tensor; checks that the tensor arrives intact."""
    x = torch.arange(mb * 2**20 // 4, dtype=torch.float32)
    t0 = time.perf_counter()
    frame = _frame_bytes(Message("x_complete", (1, {7: x})))
    t1 = time.perf_counter()
    a, b = socket.socketpair()
    try:
        sender = threading.Thread(target=a.sendall, args=(frame,))
        sender.start()
        (n,) = _LEN.unpack(receive(b, _LEN.size))
        data = receive(b, n)
        sender.join()
        t2 = time.perf_counter()
        got = Message.from_wire(data).args[1][7]
        t3 = time.perf_counter()
    finally:
        a.close()
        b.close()
    return {"receive": name, "mb": mb, "frame_bytes": len(frame),
            "pickle_and_frame_s": t1 - t0, "send_and_receive_s": t2 - t1,
            "unpickle_s": t3 - t2, "intact": bool(torch.equal(got, x))}


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mb", type=int, default=256)
    args = ap.parse_args(argv)
    rows = [time_frame(args.mb, name, receive) for name, receive
            in (("one_buffer", _recv_exact), ("by_chunks", _recv_by_chunks))]
    for row in rows:
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
