"""The parent's side of the load generator (``traffic/client.py``): the
child process, its requests in, its records and PCM out."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

CHECKOUT = Path(__file__).resolve().parents[2]


class LoadProcess:
    """One child that sends ``requests`` to the server at ``port`` from
    ``start`` (``time.monotonic()``), none at or after ``stop``, and
    waits for replies until ``deadline``."""

    def __init__(self, port: int, path: str, requests: List[Dict],
                 start: float, stop: float, deadline: float):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "perfbench.traffic.client"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            cwd=str(CHECKOUT))
        self._send({"host": "127.0.0.1", "port": port, "path": path,
                    "start": start, "stop": stop, "deadline": deadline,
                    "requests": [{"id": r["id"], "client": r["client"],
                                  "due": r["due"], "body": r["body"]}
                                 for r in requests]})

    def _send(self, obj: Dict) -> None:
        self.proc.stdin.write(json.dumps(obj) + "\n")
        self.proc.stdin.flush()

    def records(self) -> Dict:
        """``{"records", "lateness_ms"}`` once every request has ended."""
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError("the load generator ended without records")
        return json.loads(line)

    def pcm(self, ids: List[int]) -> Dict[str, str]:
        """The base64 PCM of the requests ``ids``; the child then exits."""
        self._send({"pcm": ids})
        out = json.loads(self.proc.stdout.readline())["pcm"]
        self.proc.wait(timeout=60)
        return out

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)
