"""Notebook jobs: the NotebookSubmitter analogue.

The port's copy of ``tony_tpu/cli/notebook.py``.

The reference's tony-cli ships a NotebookSubmitter that runs a single-container
Jupyter notebook on the cluster and a proxy so the user's browser can reach it
(SURVEY.md section 2 "tony-cli", "tony-proxy"). Same composition here:

- ``tony notebook --conf job.toml`` rewrites the job to one ``notebook`` task
  whose command is this module; submits it through the normal TonyClient path.
- Inside the container, :func:`run_notebook` picks a free port, announces its
  URL to the AM over the existing RegisterTensorBoardUrl RPC (the one URL
  channel the control plane already has), and starts Jupyter — or, when
  jupyter is not installed (a bare image), a minimal stdlib HTTP console page so
  the wiring is still real and testable offline.
- The client polls status until the URL appears, then starts an
  obs.proxy.ProxyServer to it and prints the local address.
"""

from __future__ import annotations

import os
import shutil
import sys
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import grpc

from tony_tpu_torch.config.config import TonyConfig
from tony_tpu_torch.config.keys import Keys
from tony_tpu_torch.utils.net import find_free_port, local_host

NOTEBOOK_JOB_TYPE = "notebook"


# --- container side -----------------------------------------------------------


def _fallback_page() -> str:
    return (
        "<!doctype html><html><head><title>tony-tpu notebook</title></head>"
        "<body><h1>tony-tpu notebook container</h1>"
        "<p>jupyter is not installed in this image; this placeholder proves "
        "the container &rarr; AM &rarr; proxy wiring. Install jupyter to get "
        "a real notebook here.</p>"
        f"<p>host: {local_host()} pid: {os.getpid()}</p></body></html>"
    )


class _FallbackHandler(BaseHTTPRequestHandler):
    def log_message(self, *args):  # quiet
        pass

    def do_GET(self):  # noqa: N802 (stdlib casing)
        raw = _fallback_page().encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/html; charset=utf-8")
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)


def _announce(url: str) -> None:
    from tony_tpu_torch.obs.reporter import MetricsReporter

    reporter = MetricsReporter()
    reporter.register_tensorboard(url)
    reporter.close()


def run_notebook() -> int:
    """Entry point of the in-container notebook process.

    The invariant both paths keep: the port is LISTENING before the URL is
    announced, because the client proxies to the URL the moment it appears
    in status.
    """
    host = local_host()
    if shutil.which("jupyter"):
        import socket
        import subprocess

        port = find_free_port()
        proc = subprocess.Popen(
            [
                "jupyter", "notebook", "--no-browser", "--allow-root",
                f"--ip={host}", f"--port={port}", "--port-retries=0",
                "--ServerApp.token=", "--ServerApp.password=",
            ],
        )
        # announce only once jupyter is accepting connections
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                socket.create_connection((host, port), timeout=1).close()
                break
            except OSError:
                time.sleep(0.25)
        if proc.poll() is not None:
            print("jupyter exited before listening", flush=True)
            return proc.returncode or 1
        _announce(f"http://{host}:{port}")
        return proc.wait()
    server = ThreadingHTTPServer((host, 0), _FallbackHandler)
    url = f"http://{host}:{server.server_address[1]}"
    _announce(url)
    print(f"notebook fallback page serving on {url}", flush=True)
    server.serve_forever()
    return 0


# --- client side --------------------------------------------------------------


def notebook_config(base: TonyConfig, memory_mb: int = 2048, cpus: int = 1,
                    tpu_chips: int = 0) -> TonyConfig:
    """Rewrite a job config to a single tracked notebook container, keeping
    the cluster/security/history settings of the base config."""
    values = {
        k: v for k, v in base.to_dict().items() if not k.startswith("job.")
    }
    values["job.notebook.instances"] = 1
    values["job.notebook.memory_mb"] = memory_mb
    values["job.notebook.cpus"] = cpus
    values["job.notebook.tpu_chips"] = tpu_chips
    values["job.notebook.command"] = "python -m tony_tpu_torch.cli.notebook"
    values[Keys.APPLICATION_FRAMEWORK] = "generic"
    return TonyConfig(values)


def launch_notebook(config: TonyConfig, *, listen_port: int = 0,
                    timeout_s: float = 60.0):
    """Submit the notebook job and proxy to it.

    Returns ``(client, proxy, url)`` once the in-container process has
    announced its URL; the caller monitors/stops the job. Raises on timeout
    or early job death.
    """
    from tony_tpu_torch.cli.client import TERMINAL_STATES, TonyClient
    from tony_tpu_torch.obs.proxy import ProxyServer
    from tony_tpu_torch.rpc import ApplicationRpcClient
    from tony_tpu_torch.rpc.auth import read_token

    client = TonyClient(config)
    client.stage()
    try:
        client.launch_am()
        addr = client.am_address()
        url = ""
        deadline = time.monotonic() + timeout_s
        with ApplicationRpcClient(addr, token=read_token(client.app_dir)) as c:
            while time.monotonic() < deadline:
                try:
                    status = c.get_application_status()
                except grpc.RpcError:
                    time.sleep(0.3)
                    continue
                if status.tensorboard_url:
                    url = status.tensorboard_url
                    break
                if status.state in TERMINAL_STATES:
                    raise RuntimeError(
                        f"notebook job {client.app_id} ended before announcing "
                        f"a URL ({status.state}: {status.diagnostics})"
                    )
                time.sleep(0.3)
        if not url:
            raise TimeoutError(
                f"notebook {client.app_id} did not announce its URL in time"
            )
    except Exception:
        _stop_job(client)  # don't leak a running AM + container
        raise
    target = url.split("//", 1)[-1]
    proxy = ProxyServer(target, listen_port=listen_port).start()
    return client, proxy, url


def _stop_job(client) -> None:
    """Best-effort teardown of a half-started notebook job."""
    from tony_tpu_torch.rpc import ApplicationRpcClient
    from tony_tpu_torch.rpc.auth import read_token

    try:
        addr_path = os.path.join(client.app_dir, "am.addr")
        with open(addr_path) as f:
            addr = f.read().strip()
        with ApplicationRpcClient(addr, timeout_s=5.0,
                                  token=read_token(client.app_dir)) as c:
            c.stop_application("notebook launch failed")
        client.monitor(quiet=True)
    except Exception:
        proc = getattr(client, "_am_proc", None)
        if proc is not None and proc.poll() is None:
            proc.terminate()


if __name__ == "__main__":
    sys.exit(run_notebook())
