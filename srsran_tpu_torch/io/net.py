"""Host copy of `srsran_tpu/io/net.py`, held to it by `tests/test_torch_stack.py`.

UDP/TCP I/Q sample transport (re-design of `lib/src/phy/io/netsource.c`,
`netsink.c` — and the ZMQ fake-RF role of `rf_zmq_imp.c`: two processes
exchange raw cf32 buffers over sockets, standing in for the radio link in
multi-process E2E tests)."""

from __future__ import annotations

import socket

import numpy as np


class NetSink:
    def __init__(self, host: str, port: int, proto: str = "udp"):
        self.proto = proto
        if proto == "udp":
            self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self.addr = (host, port)
        else:
            self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self.sock.connect((host, port))
            self.addr = None

    def write(self, samples: np.ndarray):
        data = np.asarray(samples, np.complex64).tobytes()
        if self.proto == "udp":
            mtu = 8192
            for i in range(0, len(data), mtu):
                self.sock.sendto(data[i : i + mtu], self.addr)
        else:
            self.sock.sendall(data)

    def close(self):
        self.sock.close()


class NetSource:
    def __init__(self, host: str, port: int, proto: str = "udp", timeout: float = 5.0):
        self.proto = proto
        if proto == "udp":
            self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self.sock.bind((host, port))
        else:
            self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._srv.bind((host, port))
            self._srv.listen(1)
            self.sock, _ = self._srv.accept()
        self.sock.settimeout(timeout)
        self._buf = b""

    def read(self, nsamples: int) -> np.ndarray:
        need = nsamples * 8
        while len(self._buf) < need:
            if self.proto == "udp":
                chunk, _ = self.sock.recvfrom(65536)
            else:
                chunk = self.sock.recv(65536)
                if not chunk:
                    break
            self._buf += chunk
        out = np.frombuffer(self._buf[:need], np.complex64).copy()
        self._buf = self._buf[need:]
        return out

    def close(self):
        self.sock.close()
