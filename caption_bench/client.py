"""The open loop's client: a process of its own, one thread, asyncio.

    python3 -m caption_bench.client HOST PORT PATH TIMEOUT

Run in the same process as the server, the senders would take the
interpreter's lock from the server's threads and the engine's loaders, and
the load would slow the system it measures. This module imports the
standard library alone. As a process it prints ``ready``, reads one JSON
line ``{"bodies": [...], "due": [...]}`` (absolute ``time.perf_counter``
due times: on Linux one clock across processes), sends each request at its
due time on a connection of its own, and prints one JSON line with
``[ok, done, sent, error]`` for each (null for one that did not end within
TIMEOUT seconds).
"""
from __future__ import annotations

import asyncio
import json
import sys
import time
from typing import List, Optional, Sequence, Tuple

Result = Tuple[bool, float, float, Optional[str]]


async def _post(host: str, port: int, path: str, body: bytes) -> Tuple[int, bytes]:
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write((f"POST {path} HTTP/1.1\r\nHost: {host}\r\n"
                      f"Content-Type: application/json\r\nContent-Length: {len(body)}\r\n"
                      "Connection: close\r\n\r\n").encode() + body)
        await writer.drain()
        data = await reader.read()
    finally:
        writer.close()
    head, _, payload = data.partition(b"\r\n\r\n")
    return int(head.split(b" ", 2)[1]), payload


async def _one(host, port, path, body: bytes, due: float) -> Result:
    wait = due - time.perf_counter()
    if wait > 0:
        await asyncio.sleep(wait)
    sent = time.perf_counter()
    try:
        status, payload = await _post(host, port, path, body)
        ok = status == 200 and b'"BEST"' in payload
        err = None if ok else f"status {status}: {payload[:200]!r}"
    except Exception as exc:  # counted as failed by the caller
        ok, err = False, repr(exc)
    return ok, time.perf_counter(), sent, err


def send(host: str, port: int, path: str, bodies: Sequence[bytes], due: Sequence[float],
         timeout: float) -> List[Optional[Result]]:
    """Every request at its due time; None for one that did not end
    within ``timeout`` seconds of the call."""
    async def main():
        tasks = [asyncio.ensure_future(_one(host, port, path, b, d)) for b, d in zip(bodies, due)]
        await asyncio.wait(tasks, timeout=timeout)
        out = []
        for t in tasks:
            if t.done():
                out.append(t.result())
            else:
                t.cancel()
                out.append(None)
        return out

    return asyncio.run(main())


def main(argv=None) -> int:
    host, port, path, timeout = (argv or sys.argv[1:])[:4]
    print("ready", flush=True)
    schedule = json.loads(sys.stdin.readline())
    out = send(host, int(port), path, [b.encode() for b in schedule["bodies"]],
               schedule["due"], float(timeout))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
