"""An open loop of `POST /{index}/_search` requests, from one process.

Standard library only: it loads neither the port nor torch, so its
Python shares no interpreter lock with the server. Request i is due at
i / `rate` seconds after the loop opens, whether or not earlier ones have
returned (independent users); it is sent on the first free connection of
a pool of `pool` keep-alive connections, and its latency runs from when it
was due to the last byte of its answer, so a stall counts against every
request it delays. Request i sends body i (wrapping round).

A warm-up of `--warm` seconds at the same rate comes first; the client
then prints `ready`, waits for a line on standard input, and runs the
window: the requests due in `--seconds`, which closes when the last
returns. It writes every request of the window (body number, due, sent and
end times on its own clock from the window's opening, status and the
answer's raw bytes) as JSON to `--out`.

    python3 rest_client.py --port P --index NAME --bodies FILE --count N \
        --rate 400 --pool 64 --warm 3 --seconds 30 --out FILE
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time


class Conn:
    def __init__(self, port: int, path: bytes):
        self.port, self.path = port, path
        self.reader = self.writer = None

    async def open(self) -> None:
        self.reader, self.writer = await asyncio.open_connection(
            "127.0.0.1", self.port)

    async def post(self, body: bytes) -> tuple[int, bytes]:
        head = (b"POST " + self.path + b" HTTP/1.1\r\nHost: localhost\r\n"
                b"Content-Type: application/json\r\nContent-Length: "
                + str(len(body)).encode() + b"\r\n\r\n")
        self.writer.write(head + body)
        await self.writer.drain()
        raw = await self.reader.readuntil(b"\r\n\r\n")
        lines = raw.split(b"\r\n")
        status = int(lines[0].split()[1])
        length = 0
        for line in lines[1:]:
            key, _, value = line.partition(b":")
            if key.strip().lower() == b"content-length":
                length = int(value.strip())
        return status, await self.reader.readexactly(length)


class Loop:
    """Sends requests on schedule over a pool of connections."""

    def __init__(self, conns: list, bodies: list, rate: float):
        self.pool: asyncio.Queue = asyncio.Queue()
        for c in conns:
            self.pool.put_nowait(c)
        self.bodies, self.rate = bodies, rate
        self.reconnects = 0

    async def one(self, i: int, due: float, t_open: float, out) -> None:
        conn = await self.pool.get()
        sent = time.perf_counter()
        try:
            status, data = await conn.post(self.bodies[i % len(self.bodies)])
        except (OSError, asyncio.IncompleteReadError, ValueError,
                IndexError):
            status, data = 0, b""
            conn.writer.close()
            await conn.open()
            self.reconnects += 1
        end = time.perf_counter()
        self.pool.put_nowait(conn)
        if out is not None:
            out.append((i % len(self.bodies), due - t_open, sent - t_open,
                        end - t_open, status, data))

    async def run(self, seconds: float, out) -> float:
        """The requests due in `seconds` -> the loop's opening time."""
        t_open = time.perf_counter()
        tasks = []
        for i in range(int(seconds * self.rate)):
            due = t_open + i / self.rate
            wait = due - time.perf_counter()
            if wait > 0:
                await asyncio.sleep(wait)
            tasks.append(asyncio.create_task(self.one(i, due, t_open, out)))
        await asyncio.gather(*tasks)
        return t_open


async def main_async(args) -> None:
    with open(args.bodies, "rb") as f:
        bodies = f.read().split(b"\n")[: args.count]
    path = f"/{args.index}/_search".encode()
    conns = [Conn(args.port, path) for _ in range(args.pool)]
    for c in conns:
        await c.open()
    loop = Loop(conns, bodies, args.rate)
    await loop.run(args.warm, None)
    print("ready", flush=True)
    await asyncio.get_running_loop().run_in_executor(None,
                                                     sys.stdin.readline)
    out: list = []
    await loop.run(args.seconds, out)
    for c in conns:
        c.writer.close()
    requests = [{"q": q, "due": due, "sent": sent, "end": end, "status": s,
                 "body": data.decode("utf-8", "replace")}
                for q, due, sent, end, s, data in out]
    with open(args.out, "w") as f:
        json.dump({"reconnects": loop.reconnects, "requests": requests}, f)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--index", required=True)
    ap.add_argument("--bodies", required=True)
    ap.add_argument("--count", type=int, required=True)
    ap.add_argument("--rate", type=float, required=True)
    ap.add_argument("--pool", type=int, required=True)
    ap.add_argument("--warm", type=float, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", required=True)
    asyncio.run(main_async(ap.parse_args()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
