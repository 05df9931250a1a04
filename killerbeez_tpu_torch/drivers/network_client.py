"""network_client driver — the target is a client; the fuzzer binds a
listener, the instrumentation starts the target, the target connects
to us, and we push the packet sequence down the accepted connection.

Behavioral parity with the reference network_client driver
(reference driver/network_client_driver.c:200-320:
start_listener -> enable -> accept -> send packets -> wait)."""

from __future__ import annotations

import socket
import time
from typing import List

from ..utils.logging import DEBUG_MSG
from .. import FUZZ_ERROR, FUZZ_NONE
from .factory import register_driver
from .packet_driver import PacketDriver


@register_driver
class NetworkClientDriver(PacketDriver):
    """Fuzzes a client target that connects to the fuzzer's listener."""
    name = "network_client"
    OPTION_SCHEMA = {"path": str, "arguments": str, "port": int,
                     "ip": str, "udp": int, "sleeps": list,
                     "timeout": float, "accept_timeout": float}
    OPTION_DESCS = {
        "path": "target client executable",
        "arguments": "argument string for the target",
        "port": "port we listen on for the target (required)",
        "ip": "bind address (default 127.0.0.1)",
        "udp": "1 = datagram socket instead of TCP",
        "sleeps": "per-packet pre-send sleeps in ms",
        "timeout": "seconds to wait for target exit after sending",
        "accept_timeout": "seconds to wait for the target to connect "
                          "(default 5)",
    }
    DEFAULTS = {"arguments": "", "ip": "127.0.0.1", "udp": 0,
                "timeout": 2.0, "accept_timeout": 5.0}

    # -- listener (reference start_listener) ----------------------------

    def _make_listener(self) -> socket.socket:
        """Fresh socket per exec: a reused listener can hold stale
        state from the PREVIOUS (now dead) target — a leftover datagram
        would teach the UDP path a stale peer address, and a leftover
        backlog connection would be accepted as this exec's target."""
        kind = socket.SOCK_DGRAM if self.udp else socket.SOCK_STREAM
        s = socket.socket(socket.AF_INET, kind)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self.options["ip"], self.port))
        if not self.udp:
            s.listen(1)
        return s

    def _run(self, parts: List[bytes]) -> int:
        listener = self._make_listener()
        self.instrumentation.start_process(self._cmd_line())
        sleeps = self.options.get("sleeps") or []
        try:
            if self.udp:
                listener.settimeout(float(self.options["accept_timeout"]))
                # learn the client's address from its first datagram
                _, peer = listener.recvfrom(65536)
                for i, part in enumerate(parts):
                    if i < len(sleeps) and sleeps[i]:
                        time.sleep(float(sleeps[i]) / 1000.0)
                    listener.sendto(part, peer)
            else:
                listener.settimeout(float(self.options["accept_timeout"]))
                conn, _ = listener.accept()
                # accept() returns a blocking socket regardless of the
                # listener's timeout; without this a stuck target that
                # stops reading would block sendall forever
                conn.settimeout(float(self.options["timeout"]))
                with conn:
                    for i, part in enumerate(parts):
                        if i < len(sleeps) and sleeps[i]:
                            time.sleep(float(sleeps[i]) / 1000.0)
                        conn.sendall(part)
        except OSError as e:
            DEBUG_MSG("network_client send failed: %s", e)
            verdict = self.instrumentation.wait_done(0.1)
            return verdict if verdict != FUZZ_NONE else FUZZ_ERROR
        finally:
            listener.close()
        return self.instrumentation.wait_done(
            float(self.options["timeout"]))
