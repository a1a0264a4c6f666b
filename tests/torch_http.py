"""Test helpers for the port's engine service: an event loop on a thread,
the service started on a loopback socket, and a keep-alive client on
http.client whose every wait is bounded.  Standard library and the port
only."""

import asyncio
import contextlib
import http.client
import json
import threading

from thesia_tpu_torch.engine import service as port_service

TIMEOUT = 10.0


class LoopThread:
    """An asyncio event loop running on a thread of its own."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, name="test-loop", daemon=True)
        self.thread.start()

    def run(self, coro, timeout=TIMEOUT):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(TIMEOUT)
        assert not self.thread.is_alive()
        self.loop.close()


@contextlib.contextmanager
def port_server(session, **kw):
    svc = port_service.EngineService(session, **kw)
    lt = LoopThread()
    try:
        yield svc, lt.run(svc.start("127.0.0.1", 0))
    finally:
        lt.run(svc.stop())
        lt.close()


class Reply:
    def __init__(self, status, content_type, body):
        self.status, self.content_type, self.body = status, content_type, body

    def json(self):
        return json.loads(self.body)


class Client:
    """One keep-alive connection (http.client), every wait bounded."""

    def __init__(self, port):
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)

    def request(self, method, path, body=b"", headers=None) -> Reply:
        self.conn.request(method, path, body=body, headers=headers or {})
        r = self.conn.getresponse()
        return Reply(r.status, r.getheader("Content-Type", ""), r.read())

    def post(self, path, obj=None, raw=None) -> Reply:
        body = raw if raw is not None else json.dumps({} if obj is None else obj).encode()
        return self.request("POST", path, body, {"Content-Type": "application/json"})

    def get(self, path) -> Reply:
        return self.request("GET", path)

    def call(self, name, **body):
        r = self.post(f"/api/{name}", body)
        assert r.status == 200, (name, body, r.status, r.body[:300])
        return r.body if name in port_service.BINARY_COMMANDS else r.json()["result"]

    def close(self):
        self.conn.close()
