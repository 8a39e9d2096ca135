"""Port-forwarding proxy: the tony-proxy analogue.

The port's copy of ``tony_tpu/obs/proxy.py``, stdlib only like it.

The reference ships a small proxy so users can reach services running inside
cluster containers — notebooks, TensorBoard — from outside the cluster
network (SURVEY.md section 2 "tony-proxy"). Same role here: a threaded TCP
relay from a local listen port to a task's host:port (taken from `tony
status` output or the cluster spec).

Run:  python -m tony_tpu_torch.obs.proxy --listen 9000 --target host:6006
"""

from __future__ import annotations

import argparse
import socket
import threading


def _pump(src: socket.socket, dst: socket.socket) -> None:
    try:
        while True:
            data = src.recv(1 << 16)
            if not data:
                break
            dst.sendall(data)
    except OSError:
        pass
    finally:
        for s in (src, dst):
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


class ProxyServer:
    """Accept loop on (host, listen_port), relaying to target host:port."""

    def __init__(self, target: str, listen_port: int = 0, host: str = "127.0.0.1"):
        t_host, _, t_port = target.rpartition(":")
        self.target = (t_host or "127.0.0.1", int(t_port))
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, listen_port))
        self._sock.listen(16)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)

    def start(self) -> "ProxyServer":
        self._thread.start()
        return self

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                client, _ = self._sock.accept()
            except OSError:
                return
            try:
                upstream = socket.create_connection(self.target, timeout=10)
            except OSError:
                client.close()
                continue
            threading.Thread(target=_pump, args=(client, upstream), daemon=True).start()
            threading.Thread(target=_pump, args=(upstream, client), daemon=True).start()

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass


def main() -> None:
    p = argparse.ArgumentParser(description="tony-tpu port-forwarding proxy")
    p.add_argument("--listen", type=int, required=True)
    p.add_argument("--target", required=True, help="host:port inside the cluster")
    args = p.parse_args()
    proxy = ProxyServer(args.target, args.listen, host="0.0.0.0").start()
    print(f"proxying :{proxy.port} -> {args.target}")
    threading.Event().wait()


if __name__ == "__main__":
    main()
