"""The open-loop load generator of the serving driver, in a process of its
own (its work does not hold the server's interpreter lock).

  python3 -m hdrbench.drivers.client <payload.json> <bodies.bin> <result.json>

The payload holds the server's port and the schedule: for each request its due
time (seconds after ``go``), the offset and length of its JPEG in
``bodies.bin``, and whether to keep its reply.  Each request is sent at its
due time on a connection of its own (HTTP/1.0, as the server speaks),
whatever the replies before it; its latency runs from the due time to the
last byte of the reply.  It prints ``ready`` once loaded and starts on the
line ``go <t>`` on its standard input, ``t`` on the system-wide monotonic
clock (``time.monotonic``).  Writes ``result.json`` (per request: sent late
by, latency, status) and each kept reply to ``result.json.<i>``, when every
request has ended or ``deadline`` (seconds after ``go``) has passed.
Imports only the standard library.
"""

from __future__ import annotations

import asyncio
import json
import sys
import time


async def _one(port: int, body: bytes, due: float, keep: bool, deadline: float) -> dict:
    await asyncio.sleep(max(0.0, due - time.monotonic()))
    sent = time.monotonic()
    rec = {"late_s": sent - due}
    try:
        reader, writer = await asyncio.wait_for(asyncio.open_connection("127.0.0.1", port),
                                                timeout=max(0.1, deadline - time.monotonic()))
        writer.write(b"POST /predict HTTP/1.0\r\nHost: 127.0.0.1\r\nContent-Type: image/jpeg\r\n"
                     + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        await writer.drain()
        reply = await asyncio.wait_for(reader.read(), timeout=max(0.1, deadline - time.monotonic()))
        done = time.monotonic()
        writer.close()
        head, _, payload = reply.partition(b"\r\n\r\n")
        status = int(head.split(b" ", 2)[1]) if head.startswith(b"HTTP/") else 0
        rec.update(latency_s=done - due, status=status)
        if keep and status == 200:
            rec["body"] = payload
    except (OSError, asyncio.TimeoutError, ValueError, IndexError) as e:
        rec.update(latency_s=None, status=0, error=type(e).__name__)
    return rec


async def _main(payload: dict, bodies: bytes, go: float) -> list:
    deadline = go + payload["deadline"]
    tasks = [asyncio.ensure_future(_one(payload["port"], bodies[o:o + n], go + due, keep, deadline))
             for due, o, n, keep in payload["schedule"]]
    return list(await asyncio.gather(*tasks))


def main(argv) -> int:
    payload_path, bodies_path, result_path = argv
    with open(payload_path) as f:
        payload = json.load(f)
    with open(bodies_path, "rb") as f:
        bodies = f.read()
    print("ready", flush=True)
    go = float(sys.stdin.readline().split()[1])
    results = asyncio.run(_main(payload, bodies, go))
    for i, rec in enumerate(results):
        body = rec.pop("body", None)
        if body is not None:
            with open(f"{result_path}.{i}", "wb") as f:
                f.write(body)
            rec["kept"] = True
    with open(result_path, "w") as f:
        json.dump(results, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
