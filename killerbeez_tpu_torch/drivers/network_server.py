"""network_server driver — the target is a server; the fuzzer
connects and delivers the input as a sequence of network packets.

Behavioral parity with the reference network_server driver
(reference driver/network_server_driver.c): start the
target via the instrumentation's async enable, poll until the port is
listening, connect (TCP or UDP), send N packets with optional
inter-packet sleeps, then wait for process completion with the
timeout->FUZZ_HANG rule. Multi-packet inputs come from multipart
mutators via ``mutate_extended(MUTATE_MULTIPLE_INPUTS|i)`` and the
last input serializes via ``encode_mem_array``.
"""

from __future__ import annotations

import socket
import time
from typing import List

from ..utils.logging import DEBUG_MSG, WARNING_MSG
from .. import FUZZ_ERROR, FUZZ_NONE
from .factory import register_driver
from .packet_driver import PacketDriver


_TCP_LISTEN = 0x0A


def is_port_listening(port: int, udp: bool = False,
                      host: str = "127.0.0.1") -> bool:
    """True when a socket is bound/listening on host:port, determined
    from /proc/net/{tcp,udp} WITHOUT connecting (reference
    is_port_listening reads the kernel table for the same reason: a
    probe connection would consume the target's accept()). A listener
    on INADDR_ANY matches any host."""
    try:
        want = int.from_bytes(socket.inet_aton(host), "little")
    except OSError:
        want = None  # non-IPv4 host string: match port only
    tables = (["/proc/net/udp", "/proc/net/udp6"] if udp
              else ["/proc/net/tcp", "/proc/net/tcp6"])
    for table in tables:
        v6 = table.endswith("6")
        try:
            with open(table) as f:
                lines = f.readlines()[1:]
        except OSError:
            continue
        for ln in lines:
            fields = ln.split()
            if len(fields) < 4:
                continue
            try:
                addr_hex, port_hex = fields[1].split(":")
                local_port = int(port_hex, 16)
                state = int(fields[3], 16)
            except (ValueError, IndexError):
                continue
            if local_port != port:
                continue
            if not udp and state != _TCP_LISTEN:
                continue
            if want is not None:
                if v6:
                    # match v4-mapped (::ffff:a.b.c.d) or in6addr_any
                    tail = int(addr_hex[-8:], 16)
                    if int(addr_hex, 16) != 0 and tail != want:
                        continue
                else:
                    addr = int(addr_hex, 16)
                    if addr != 0 and addr != want:
                        continue
            return True
    return False


@register_driver
class NetworkServerDriver(PacketDriver):
    """Fuzzes a server target over TCP/UDP packet sequences."""
    name = "network_server"
    OPTION_SCHEMA = {"path": str, "arguments": str, "port": int,
                     "ip": str, "udp": int, "sleeps": list,
                     "timeout": float,
                     "skip_network_check": int, "listen_timeout": float}
    OPTION_DESCS = {
        "path": "target server executable",
        "arguments": "argument string for the target",
        "port": "port the target listens on (required)",
        "ip": "target address (default 127.0.0.1)",
        "udp": "1 = datagrams instead of a TCP stream",
        "sleeps": "per-packet pre-send sleeps in ms",
        "timeout": "seconds to wait for target exit after sending "
                   "(then FUZZ_HANG; default 2.0)",
        "skip_network_check": "1 = don't wait for the port to listen",
        "listen_timeout": "max seconds to wait for the port (default 5)",
    }
    DEFAULTS = {"arguments": "", "ip": "127.0.0.1", "udp": 0,
                "timeout": 2.0, "skip_network_check": 0,
                "listen_timeout": 5.0}

    # -- packet delivery ------------------------------------------------

    def _wait_listening(self) -> bool:
        if self.options["skip_network_check"]:
            return True
        deadline = time.time() + float(self.options["listen_timeout"])
        while time.time() < deadline:
            if self.instrumentation.is_process_done():
                return False  # died before listening
            if is_port_listening(self.port, self.udp,
                                 self.options["ip"]):
                return True
            time.sleep(0.005)
        return False

    def _send_packets(self, parts: List[bytes]) -> bool:
        sleeps = self.options.get("sleeps") or []
        try:
            if self.udp:
                sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            else:
                sock = socket.create_connection(
                    (self.options["ip"], self.port), timeout=2.0)
            with sock:
                for i, part in enumerate(parts):
                    if i < len(sleeps) and sleeps[i]:
                        time.sleep(float(sleeps[i]) / 1000.0)
                    if self.udp:
                        sock.sendto(part,
                                    (self.options["ip"], self.port))
                    else:
                        sock.sendall(part)
            return True
        except OSError as e:
            DEBUG_MSG("network_server send failed: %s", e)
            return False

    def _run(self, parts: List[bytes]) -> int:
        self.instrumentation.start_process(self._cmd_line())
        if not self._wait_listening():
            if self.instrumentation.is_process_done():
                # died before listening: collect the verdict (a crash
                # before listen is still a crash)
                return self.instrumentation.wait_done(0.1)
            # alive but never opened the port: a config/startup problem,
            # not a hang — don't let it pollute the hang virgin map
            WARNING_MSG("network_server: target never listened on port "
                        "%d within %.1fs", self.port,
                        float(self.options["listen_timeout"]))
            return self.instrumentation.abort_process()
        if not self._send_packets(parts):
            # a mid-sequence crash resets the connection and fails the
            # send — the target's verdict is the real signal
            verdict = self.instrumentation.wait_done(0.1)
            return verdict if verdict != FUZZ_NONE else FUZZ_ERROR
        return self.instrumentation.wait_done(
            float(self.options["timeout"]))

    def cleanup(self) -> None:
        try:
            if not self.instrumentation.is_process_done():
                self.instrumentation.wait_done(0.0)
        except (NotImplementedError, RuntimeError) as e:
            WARNING_MSG("network_server cleanup: %s", e)
