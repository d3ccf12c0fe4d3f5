"""The load generator: a child process that sends the run's requests.

It runs apart from the server so that it does not share the server's
interpreter lock.  ``stream_chunks`` is a copy of the port's
``serve/client.py::stream_chunks`` (chunk boundaries kept, each chunk with
its arrival time), with a deadline.  Times are ``time.monotonic()``, the
clock the parent reads too.

Protocol on the pipes, one JSON object a line:
1. in: ``{"host", "port", "path", "start", "stop", "deadline",
   "requests": [{"id", "client", "due", "body"}]}``: a closed-loop
   request has a ``client`` and no ``due``; an open-loop one a ``due``
   (seconds after ``start``).  Nothing is sent at or after ``stop``.
2. out: ``{"records": [...], "lateness_ms": [...]}`` once every request
   sent has ended or ``deadline`` passed (a request still open then is
   recorded as late).
3. in: ``{"pcm": [ids]}``; out: ``{"pcm": {id: base64 float32 PCM}}``.

    python -m perfbench.traffic.client   (driven by the harness)
"""
from __future__ import annotations

import base64
import json
import socket
import sys
import threading
import time
from typing import Dict, Iterator, List, Tuple


def stream_chunks(host: str, port: int, path: str, payload: Dict,
                  deadline: float) -> Iterator[Tuple[float, bytes]]:
    """POST ``payload`` as JSON; yield (arrival time, chunk bytes) for each
    chunk of the chunked response as it arrives."""
    body = json.dumps(payload).encode()
    with socket.create_connection((host, port), timeout=10.0) as sock:
        sock.sendall(
            f"POST {path} HTTP/1.1\r\nHost: {host}\r\n"
            "Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        sock.settimeout(max(0.1, deadline - time.monotonic()))
        f = sock.makefile("rb")
        status = f.readline().decode()
        if " 200 " not in status:
            raise RuntimeError(f"HTTP error: {status.strip()}")
        while f.readline() not in (b"\r\n", b"\n", b""):
            pass
        while True:
            line = f.readline()
            if not line:
                raise RuntimeError("connection closed mid-body")
            size = int(line.strip() or b"0", 16)
            if size == 0:
                break
            data = f.read(size)
            if len(data) != size:
                raise RuntimeError("short chunk")
            yield time.monotonic(), data
            f.readline()
            sock.settimeout(max(0.1, deadline - time.monotonic()))


class Load:
    def __init__(self, spec: Dict):
        self.spec = spec
        self.records: Dict[int, Dict] = {}
        self.pcm: Dict[int, bytes] = {}
        self.lateness: List[float] = []
        self.threads: List[threading.Thread] = []
        self.lock = threading.Lock()

    def one(self, req: Dict, due: float) -> None:
        s = self.spec
        rec = {"id": req["id"], "due": due, "sent": time.monotonic(),
               "chunks": [], "ok": False, "error": None}
        with self.lock:
            self.records[req["id"]] = rec
        parts = []
        try:
            for t, data in stream_chunks(s["host"], s["port"], s["path"],
                                         req["body"], s["deadline"]):
                rec["chunks"].append((t, len(data)))
                parts.append(data)
            rec["ok"] = True
        except (OSError, RuntimeError, ValueError) as e:
            rec["error"] = f"{type(e).__name__}: {e}"
        rec["end"] = time.monotonic()
        self.pcm[req["id"]] = b"".join(parts)

    def closed_client(self, reqs: List[Dict]) -> None:
        for req in reqs:
            now = time.monotonic()
            if now >= self.spec["stop"]:
                return
            self.one(req, now)

    def open_schedule(self, reqs: List[Dict]) -> None:
        start = self.spec["start"]
        for req in reqs:
            due = start + req["due"]
            if due >= self.spec["stop"]:
                return
            wait = due - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            t = threading.Thread(target=self.one, args=(req, due),
                                 daemon=True)
            t.start()
            self.lateness.append(time.monotonic() - due)
            with self.lock:
                self.threads.append(t)

    def run(self) -> None:
        s = self.spec
        reqs = s["requests"]
        wait = s["start"] - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        if all(r["client"] is not None for r in reqs):
            by_client: Dict[int, List[Dict]] = {}
            for r in reqs:
                by_client.setdefault(r["client"], []).append(r)
            senders = [threading.Thread(target=self.closed_client,
                                        args=(rs,), daemon=True)
                       for _, rs in sorted(by_client.items())]
        else:
            senders = [threading.Thread(target=self.open_schedule,
                                        args=(reqs,), daemon=True)]
        for d in senders:
            d.start()
        for d in senders:
            d.join(max(0.0, s["deadline"] - time.monotonic()))
        with self.lock:
            threads = list(self.threads)
        for t in threads:
            t.join(max(0.0, s["deadline"] - time.monotonic()))
        for rec in list(self.records.values()):
            if "end" not in rec:
                rec["error"] = rec["error"] or "late: open at the deadline"


def main() -> None:
    spec = json.loads(sys.stdin.readline())
    load = Load(spec)
    load.run()
    with load.lock:
        records = [dict(r) for r in load.records.values()]
    sys.stdout.write(json.dumps({"records": records,
                                 "lateness_ms": [x * 1e3 for x in
                                                 load.lateness]}) + "\n")
    sys.stdout.flush()
    line = sys.stdin.readline()
    want = json.loads(line)["pcm"] if line else []
    out = {str(i): base64.b64encode(load.pcm.get(i, b"")).decode()
           for i in want}
    sys.stdout.write(json.dumps({"pcm": out}) + "\n")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
