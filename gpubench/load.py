"""The serving cells' load: closed-loop HTTP clients, in a process of their
own so that their JSON work does not share the daemon's interpreter lock.
Imports nothing but the standard library and numpy."""

from __future__ import annotations

import http.client
import json
import threading
import time

import numpy as np


class Clients:
    """``n`` closed-loop clients, each on its own keep-alive connection; each
    sends its next request when its reply arrives. ``replies`` (a shared
    counter) counts the replies."""

    def __init__(self, port: int, ids: list[str], n: int, per_request, seed: int, replies):
        self.port, self.ids, self.per_request, self.seed = port, ids, per_request, seed
        self.replies = replies
        self.stop = threading.Event()
        self.records: list[tuple] = []  # (sent, done, ids, ok, results)
        self.threads = [threading.Thread(target=self._loop, args=(c,), daemon=True)
                        for c in range(n)]

    def start(self) -> None:
        for t in self.threads:
            t.start()

    def join(self, timeout: float) -> bool:
        end = time.monotonic() + timeout
        for t in self.threads:
            t.join(max(0.0, end - time.monotonic()))
        return not any(t.is_alive() for t in self.threads)

    def _loop(self, c: int) -> None:
        rng = np.random.default_rng([self.seed % 2**63, 3, c])
        lo, hi = self.per_request
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=600)
        try:
            while not self.stop.is_set():
                k = int(rng.integers(lo, hi + 1))
                ids = [self.ids[i] for i in rng.choice(len(self.ids), size=k, replace=False)]
                body = json.dumps({"videos": [{"video_id": i} for i in ids]})
                sent = time.perf_counter()
                try:
                    conn.request("POST", "/score", body, {"Content-Type": "application/json"})
                    resp = conn.getresponse()
                    data = resp.read()
                    ok = resp.status == 200
                    results = json.loads(data)["results"] if ok else []
                except (OSError, http.client.HTTPException, ValueError, KeyError):
                    conn.close()
                    conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=600)
                    ok, results = False, []
                self.records.append((sent, time.perf_counter(), ids, ok, results))
                with self.replies.get_lock():
                    self.replies.value += 1
        finally:
            conn.close()


def run_load(port, ids, n, per_request, seed, replies, stop, out) -> None:
    """The load process: the clients until ``stop`` is set, then every
    record (``time.perf_counter``, the machine's monotonic clock, which the
    parent shares) onto ``out``, with whether every client ended."""
    clients = Clients(port, ids, n, per_request, seed, replies)
    clients.start()
    stop.wait()
    clients.stop.set()
    finished = clients.join(120.0)
    out.put((clients.records, finished))
