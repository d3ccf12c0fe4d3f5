"""The generator (same sizes for every seed, a seed reproduces its
schedule) and the load generator's due-time accounting against a tiny
chunked HTTP server on localhost."""
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from perfbench.spec import Bench
from perfbench.traffic import generate
from perfbench.traffic.drive import LoadProcess

CLOSED = {"loop": "closed", "clients": 3, "requests_per_client": 40,
          "endpoint": "/tts", "shape_seed": 7,
          "reply": {"sentences": [1, 2, 3, 4], "p": [0.45, 0.3, 0.15, 0.1],
                    "chars": [40, 160], "period": 20}}
OPEN = {"loop": "open", "endpoint": "/tts", "shape_seed": 9,
        "prompt": {"median": 80, "sigma": 0.8, "min": 20, "max": 400}}


@pytest.mark.parametrize("mix,rate", [(CLOSED, None), (OPEN, 5.0)])
def test_seed_reproduces_and_sizes_are_shared(mix, rate):
    a = generate.requests(mix, 2 ** 31 + 5, 10.0, rate)
    b = generate.requests(mix, 2 ** 31 + 5, 10.0, rate)
    c = generate.requests(mix, 17, 10.0, rate)
    assert a == b
    assert [r["body"] for r in a] != [r["body"] for r in c]
    if mix["loop"] == "closed":
        assert all(r["due"] is None for r in a)
        assert [r["client"] for r in a[:6]] == [0, 1, 2, 0, 1, 2]
        for rs in (a, c):
            for k in range(3):
                mine = [r for r in rs if r["client"] == k]
                # any period of a client's replies: 9, 6, 3 and 2 replies
                # of 1..4 sentences, the same lengths for every seed
                for at in (0, 7):
                    part = mine[at:at + 20]
                    counts = sorted(len(r["sentences"]) for r in part)
                    assert counts == [1] * 9 + [2] * 6 + [3] * 3 + [4] * 2
                    lens = sorted(len(s) for r in part
                                  for s in r["sentences"])
                    assert lens == sorted(
                        len(s) for r in [x for x in a
                                         if x["client"] == 0][:20]
                        for s in r["sentences"])
    else:
        # the same arrivals and prompt lengths for every seed
        assert [r["due"] for r in a] == [r["due"] for r in c]
        assert [len(r["body"]["text"]) for r in a] == \
            [len(r["body"]["text"]) for r in c]
        assert len(a) >= 5.0 * 10.0
        assert all(x["due"] < y["due"] for x, y in zip(a, a[1:]))


def test_texts_are_unique_and_clean():
    rs = generate.requests(CLOSED, 3, 10.0)
    texts = [r["body"]["text"] for r in rs]
    assert len(set(texts)) == len(texts)
    for r in rs:
        for s in r["sentences"]:
            assert s.endswith(".") and s.count(".") == 1
            assert 40 <= len(s) <= 160
        words = r["body"]["text"].split(" ")
        assert sum(w.endswith(".") for w in words) == len(r["sentences"])


def test_cell_mixes_parse():
    b = Bench()
    for w in b.doc["workloads"]:
        wl = b.workload(w["name"])
        rs = generate.requests(b.mix(wl["traffic"]), 1, 10.0,
                               wl.get("rate"))
        assert rs


class _Chunks(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    delay = 0.2

    def do_POST(self):
        self.rfile.read(int(self.headers["Content-Length"]))
        self.send_response(200)
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        for _ in range(2):
            time.sleep(self.delay)
            data = b"\0" * 1280
            self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
            self.wfile.flush()
        self.wfile.write(b"0\r\n\r\n")

    def log_message(self, *a):
        pass


@pytest.fixture
def server():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Chunks)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv.server_address[1]
    srv.shutdown()
    t.join(timeout=10)


def _drive(port, reqs, start, stop, deadline):
    load = LoadProcess(port, "/tts", reqs, start, stop, deadline)
    try:
        out = load.records()
        pcm = load.pcm([reqs[0]["id"]])
    finally:
        load.close()
    return out, pcm


def test_open_loop_times_from_the_due_time(server):
    start = time.monotonic() + 0.5
    reqs = [{"id": i, "client": None, "due": 0.1 * i, "body": {"text": "x"}}
            for i in range(5)]
    out, pcm = _drive(server, reqs, start, start + 0.45, start + 10)
    recs = sorted(out["records"], key=lambda r: r["id"])
    # due at 0, 0.1 .. 0.4 s; nothing due at or after the stop
    assert [r["id"] for r in recs] == [0, 1, 2, 3, 4]
    for r in recs:
        assert r["due"] == pytest.approx(start + 0.1 * r["id"])
        assert r["sent"] >= r["due"] - 1e-3
        assert r["ok"] and len(r["chunks"]) == 2
        assert r["chunks"][0][0] - r["due"] >= _Chunks.delay - 0.02
    assert len(out["lateness_ms"]) == 5
    assert len(pcm["0"]) > 0


def test_closed_loop_sends_after_the_last_reply(server):
    start = time.monotonic() + 0.5
    reqs = [{"id": i, "client": 0, "due": None, "body": {"text": "x"}}
            for i in range(10)]
    out, _ = _drive(server, reqs, start, start + 0.9, start + 10)
    recs = sorted(out["records"], key=lambda r: r["id"])
    # each request takes two 0.2 s chunks: 0.0, 0.4 and 0.8 s are sent
    assert [r["id"] for r in recs] == [0, 1, 2]
    for a, b in zip(recs, recs[1:]):
        assert b["sent"] >= a["end"]
        assert b["due"] == pytest.approx(b["sent"], abs=1e-3)


def test_late_request_fails(server):
    start = time.monotonic() + 0.3
    reqs = [{"id": 0, "client": None, "due": 0.0, "body": {"text": "x"}}]
    out, _ = _drive(server, reqs, start, start + 0.1, start + 0.25)
    (rec,) = out["records"]
    assert not rec["ok"] and rec["error"]
