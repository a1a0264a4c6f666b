"""The headless browser of tests/fakedom.py, bridged into the PORT's service
(thesia_tpu_torch.engine.service), and an interpreter that keeps what the
viewer's async code means when a call is not awaited.

``PortBrowser`` is a ``FakeBrowser`` whose construction, ``/api`` dispatch,
``/upload`` and ``/debug/metrics`` go through the port: ``Commands.call``
(the port's command table, statuses and JSON mapping), ``EngineService``
(its metrics route) and ``_jsonable``, uploads under
``<tmp>/thesia_tpu_torch_uploads``.  It never runs ``FakeBrowser.__init__``,
which imports the JAX service.  ``failing`` names commands the fake network
answers with a 500, for the fault tests.

``AsyncInterp`` is ``tests/jsinterp.py``'s interpreter with the rejection
half of JS promises.  The base interpreter models async functions
synchronously: ``await`` is the identity, and an exception thrown in an
async function reaches its caller whether the call was awaited or not, and
skips a ``.catch`` chained on the call.  In a browser, calling an async
function never throws: it returns a promise, which ``await`` unwraps (and
rethrows), ``.catch`` handles, and a bare unawaited call drops, leaving the
rejection unhandled.  ``AsyncInterp`` keeps ``await`` and the ``async``
modifier of ``async function`` declarations in the tree; such a function
returns a ``RejectedPromise`` when its body throws, ``await`` rethrows it,
``.catch`` / ``.then(_, onRejected)`` handle it, ``.then(f)`` and
``.finally`` pass it on, and ``Promise.all`` rejects with the first one.
``unhandled()`` lists the rejections nothing handled, as a browser console
would.  Async class methods and async arrows keep the synchronous model.
"""

from __future__ import annotations

import asyncio
import json as _json
import pathlib
import tempfile

from tests.fakedom import FakeBrowser
from tests.fakedom import to_js_json
from tests.jsinterp import UNDEF, Interp, JSArrayBuffer, JSFunction, JSThrow, Parser, tokenize


class AwaitParser(Parser):
    """Keeps ``await`` as an ("await", expr) node and marks ``async function``
    declarations ("asyncfuncdecl")."""

    def parse_unary(self):
        t = self.peek()
        if t.kind == "id" and t.val == "await":
            self.next()
            return ("await", self.parse_unary())
        return super().parse_unary()

    def parse_statement(self):
        t = self.peek()
        if t.kind == "id" and t.val == "async" and self.peek(1).val == "function":
            self.next()
            return ("asyncfuncdecl",) + tuple(self.parse_function_decl()[1:])
        return super().parse_statement()


class RejectedPromise:
    """What an async function that threw returns."""

    __slots__ = ("error", "handled")

    def __init__(self, error: JSThrow):
        self.error = error
        self.handled = False


class AsyncJSFunction(JSFunction):
    """A function declared ``async``: a throw becomes a rejected promise."""

    def __call__(self, *args):
        try:
            return super().__call__(*args)
        except JSThrow as e:
            return self.interp.reject(e)


class AsyncInterp(Interp):
    def __init__(self):
        super().__init__()
        self.rejections: list[RejectedPromise] = []

    def load(self, source: str):
        self.load_ast(AwaitParser(tokenize(source)).parse_program())

    def reject(self, error: JSThrow) -> RejectedPromise:
        p = RejectedPromise(error)
        self.rejections.append(p)
        return p

    def unhandled(self) -> list:
        """The thrown values of every rejection nothing handled."""
        return [p.error.value for p in self.rejections if not p.handled]

    def exec(self, node, env):
        if node[0] == "asyncfuncdecl":
            env.declare(node[1], AsyncJSFunction(node[1], node[2], node[3], env, self))
            return None
        return super().exec(node, env)

    def eval(self, node, env):
        if node[0] == "await":
            value = self.eval(node[1], env)
            if isinstance(value, RejectedPromise):
                value.handled = True
                raise value.error
            return value
        return super().eval(node, env)

    def _call_method(self, obj, name, args):
        if isinstance(obj, RejectedPromise):
            if name == "catch" or (name == "then" and len(args) > 1):
                obj.handled = True
                return args[-1](obj.error.value)
            if name == "finally":
                args[0]()
            return obj
        return super()._call_method(obj, name, args)

    def promise_all(self, values):
        """Promise.all: the first rejection, which handles the others."""
        values = list(values)
        rejected = [v for v in values if isinstance(v, RejectedPromise)]
        for v in rejected:
            v.handled = True
        return self.reject(rejected[0].error) if rejected else values


class PortBrowser(FakeBrowser):
    """FakeBrowser on the port's service."""

    def __init__(self, session, index_html: str, media_paths=None):
        from thesia_tpu_torch.engine.service import EngineService, _jsonable

        self.session = session
        self.service = EngineService(session)
        self.commands = self.service.commands
        self._jsonable = _jsonable
        self.media_paths = [str(p) for p in (media_paths or [])]
        self.now_ms = 0.0
        self.timers = []  # (due_ms, seq, fn) one-shot
        self.raf = []  # pending animation frame callbacks
        self._seq = 0
        self.doc = self._build_document(index_html)
        self.local_storage = {}
        self.fetch_log = []  # every fetched URL, in order (tests inspect)
        self.audio_contexts = []  # fake AudioContexts (clock-synced dicts)
        self.failing = set()  # command names answered with HTTP 500

    def install(self, interp):
        super().install(interp)
        if isinstance(interp, AsyncInterp):
            interp.global_env.vars["Promise"] = {
                "all": interp.promise_all,
                "resolve": lambda v=UNDEF: v,
            }

    def fetch(self, url, opts=None):
        url = str(url)
        if url == "/upload":
            self.fetch_log.append(url)
            fd = opts.get("body") if isinstance(opts, dict) else None
            f = fd.get("_file") if isinstance(fd, dict) else None
            if not isinstance(f, dict) or "name" not in f:
                return self._resp(False, 400, {"error": "expected multipart field 'file'"})
            updir = pathlib.Path(tempfile.gettempdir()) / "thesia_tpu_torch_uploads"
            updir.mkdir(exist_ok=True)
            dest = pathlib.Path(tempfile.mkdtemp(dir=updir)) / pathlib.Path(f["name"]).name
            dest.write_bytes(f.get("bytes", b""))
            return self._resp(True, 200, {"result": str(dest)})
        if url == "/debug/metrics":
            self.fetch_log.append(url)
            out = _json.loads(asyncio.run(self.service.handle_metrics(None)).body)
            return self._resp(True, 200, out)
        if opts is None:
            return super().fetch(url)
        return super().fetch(url, opts)

    def _resp(self, ok, status, payload=None, raw=None):
        payload = to_js_json(payload)
        return {
            "ok": ok,
            "status": float(status),
            "json": (lambda p=payload: p),
            "arrayBuffer": (lambda r=raw: JSArrayBuffer(r or b"")),
            "read": (lambda r=raw: r),
        }

    def _dispatch(self, name, body, resp):
        if name in self.failing:
            return resp(False, 500, {"error": f"{name}: the engine is unreachable"})
        status, payload = self.commands.call(name, body)
        if status != 200:
            return resp(False, status, payload)
        if isinstance(payload, bytes):
            return resp(True, 200, raw=payload)
        return resp(True, 200, payload)
