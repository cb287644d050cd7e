"""Polling health probe: the payload of the ``helm test`` hook pod.

The port's copy of the JAX package's ``kvedge_tpu/runtime/healthcheck.py``
(framework-free), unchanged but for this docstring: poll the runtime's
``/healthz`` until it answers 200 (payload check passed) or a deadline
expires. Polling rather than a single probe, because the runtime serves
503 while it boots (the serve payload restores, warms and captures
first).

One 503 is *not* worth polling out: a poisoned serving pool that has
exhausted (or never had) in-process recovery marks its /healthz body
``"terminal": true`` because it only recovers by rescheduling — the
probe fails fast. A pool the recovery supervisor is healing answers 503
NON-terminal with ``"recovering": true`` and a retry-after hint, and
the probe keeps polling, as it does through ``booting``.

Usable standalone against any deployment:

    python -m kvedge_torch.runtime.healthcheck http://<ip>:8476/healthz
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.error
import urllib.request


def wait_healthy(url: str, deadline_s: float = 240.0,
                 interval_s: float = 5.0) -> tuple[bool, str]:
    """Poll ``url`` until HTTP 200 or deadline. Returns (ok, last_detail).

    A 503 whose JSON body carries ``"terminal": true`` (a poisoned
    serving pool past recovery — boot.py's health_detail) returns
    failure immediately: that state never clears without a reschedule,
    so continuing to poll would only delay the verdict. A non-terminal
    503 — booting, or ``"recovering": true`` while the recovery
    supervisor heals the pool in place — keeps polling to the deadline.
    """
    deadline = time.monotonic() + deadline_s
    detail = "no attempt made"
    while True:
        try:
            with urllib.request.urlopen(url, timeout=10) as resp:
                return True, f"HTTP {resp.status}"
        except urllib.error.HTTPError as e:
            # 503 = runtime up but degraded/booting; keep polling unless
            # the body says the degradation is terminal.
            body = e.read().decode(errors="replace")
            detail = f"HTTP {e.code}: {body!r}"
            try:
                doc = json.loads(body)
            except ValueError:
                doc = {}
            if isinstance(doc, dict) and doc.get("terminal"):
                return False, detail
        except Exception as e:  # DNS not yet registered, conn refused, ...
            detail = f"{type(e).__name__}: {e}"
        if time.monotonic() >= deadline:
            return False, detail
        time.sleep(min(interval_s, max(0.0, deadline - time.monotonic())))


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="kvedge-healthcheck",
        description="Poll a kvedge runtime /healthz until healthy.",
    )
    parser.add_argument("url")
    parser.add_argument("--deadline", type=float, default=240.0,
                        help="seconds to keep polling (default 240)")
    parser.add_argument("--interval", type=float, default=5.0,
                        help="seconds between attempts (default 5)")
    args = parser.parse_args(argv)
    ok, detail = wait_healthy(args.url, args.deadline, args.interval)
    print(f"[kvedge-healthcheck] {args.url}: "
          f"{'healthy' if ok else 'NOT healthy'} ({detail})", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
