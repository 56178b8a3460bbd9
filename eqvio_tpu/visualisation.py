"""Offline visualisation: trajectory, landmarks and feature overlays.

Replaces the reference's live GLUT/OpenCV display stack
(``src/VIOVisualiser.cpp``, ``libs/visualisation/Plotter``) with headless
matplotlib figure generation — the practical form for hosts with no
display.  Includes the online SIM(3) alignment of estimate to ground truth
that the reference visualiser performs (``VIOVisualiser.cpp:25-110``).
"""

from __future__ import annotations

import numpy as np

from .runner import umeyama_alignment


def plot_trajectory(est_pos, gt_pos=None, path: str | None = None, align: bool = True):
    """3-D + top-down trajectory figure; optionally SIM(3)-aligned to GT."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    est_pos = np.asarray(est_pos)
    if gt_pos is not None and align:
        s, R, t = umeyama_alignment(est_pos, np.asarray(gt_pos))
        est_pos = (s * (R @ est_pos.T)).T + t

    fig = plt.figure(figsize=(12, 5))
    ax3 = fig.add_subplot(1, 2, 1, projection="3d")
    ax3.plot(*est_pos.T, label="estimate")
    if gt_pos is not None:
        ax3.plot(*np.asarray(gt_pos).T, "--", label="ground truth")
    ax3.legend()
    ax3.set_title("trajectory")

    ax2 = fig.add_subplot(1, 2, 2)
    ax2.plot(est_pos[:, 0], est_pos[:, 1], label="estimate")
    if gt_pos is not None:
        g = np.asarray(gt_pos)
        ax2.plot(g[:, 0], g[:, 1], "--", label="ground truth")
    ax2.set_aspect("equal")
    ax2.set_title("top-down (xy)")
    ax2.legend()

    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig


def plot_feature_overlay(image, pixels, mask, path: str | None = None):
    """Feature positions drawn over a frame (VIOVisualiser::displayFeatureImage)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 6))
    ax.imshow(np.asarray(image), cmap="gray")
    px = np.asarray(pixels)[np.asarray(mask)]
    ax.scatter(px[:, 0], px[:, 1], s=40, facecolors="none", edgecolors="lime")
    ax.set_axis_off()
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig


def plot_nees(times, nees, path: str | None = None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 4))
    ax.plot(np.asarray(times), np.asarray(nees))
    ax.axhline(1.0, color="k", linestyle="--", alpha=0.5)
    ax.set_yscale("log")
    ax.set_xlabel("time (s)")
    ax.set_ylabel("NEES")
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig


def plot_timing(timing: dict, out_dir: str | None = None,
                stack_keys=("features", "propagation", "preprocessing",
                            "correction", "write output")):
    """Timing figures from a {label: per-frame ms} dict
    (``analysis.load_timing_csv``): a stacked per-frame area chart with the
    mean-total line, a per-section boxplot, and per-section histograms —
    the reference's offline timing toolkit (``analyse_timing_data.py``).
    """
    import os

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    keys = [k for k in stack_keys if k in timing]
    if not keys:
        keys = [k for k in timing if k != "total"]
    n = min(len(timing[k]) for k in keys)
    frames = np.arange(n)

    figs = {}

    fig, ax = plt.subplots(figsize=(10, 5))
    base = np.zeros(n)
    for k in keys:
        top = base + np.asarray(timing[k][:n])
        ax.fill_between(frames, base, top, label=k, linewidth=0)
        base = top
    ax.axhline(float(np.mean(base)), color="k", linestyle=":",
               label=f"mean {np.mean(base):.2f} ms")
    ax.set_xlabel("frame")
    ax.set_ylabel("time (ms)")
    ax.set_xlim(0, max(n - 1, 1))
    ax.set_ylim(0, None)
    ax.legend(loc="upper right", fontsize=8)
    figs["timing_flamegraph"] = fig

    fig, ax = plt.subplots(figsize=(8, 5))
    ax.boxplot([np.asarray(timing[k][:n]) for k in keys], tick_labels=keys, sym="")
    ax.set_ylabel("time (ms)")
    fig.autofmt_xdate(rotation=30)
    figs["timing_boxplots"] = fig

    fig, axs = plt.subplots(len(keys), 1, figsize=(8, 2 * len(keys)), sharex=True)
    for ax, k in zip(np.atleast_1d(axs), keys):
        ax.hist(np.asarray(timing[k][:n]), bins=40)
        ax.set_ylabel(k, fontsize=8)
    np.atleast_1d(axs)[-1].set_xlabel("time (ms)")
    figs["timing_histograms"] = fig

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        paths = {}
        for name, fig in figs.items():
            p = os.path.join(out_dir, name + ".pdf")
            fig.savefig(p, bbox_inches="tight")
            plt.close(fig)
            paths[name] = p
        return paths
    return figs


class MapDisplay:
    """Stateful 3-D map view: trajectory trails, live + persistent landmarks.

    Headless equivalent of ``VIOVisualiser::updateMapDisplay``
    (``VIOVisualiser.cpp:139-228``): landmark lifetimes are counted per id
    and points seen in more than ``minimum_life`` frames are pinned into a
    persistent world map; the estimate is SE(3)+scale-aligned online to any
    ground truth seen so far. ``render()`` draws the accumulated map instead
    of pushing to a GLUT window.
    """

    def __init__(self, minimum_life: int = 3):
        self.minimum_life = minimum_life
        self.times: list[float] = []
        self.trail: list[np.ndarray] = []
        self.gt_trail: list[np.ndarray] = []
        self.lifetimes: dict[int, int] = {}
        self.persistent: dict[int, np.ndarray] = {}
        self.current_world: np.ndarray = np.zeros((0, 3))
        self.last_pose: tuple[np.ndarray, np.ndarray] | None = None

    def update(self, time, pose_R, pose_x, cam_offset_R, cam_offset_x,
               cam_points, ids, mask, gt_position=None):
        """Record one frame: IMU pose, camera-frame landmarks, optional GT."""
        pose_R = np.asarray(pose_R)
        pose_x = np.asarray(pose_x)
        cam_R = pose_R @ np.asarray(cam_offset_R)
        cam_x = pose_R @ np.asarray(cam_offset_x) + pose_x
        self.times.append(float(time))
        self.trail.append(pose_x)
        self.last_pose = (pose_R, pose_x)
        if gt_position is not None:
            self.gt_trail.append(np.asarray(gt_position))

        pts = np.asarray(cam_points)
        ids = np.asarray(ids)
        mask = np.asarray(mask)
        world = (cam_R @ pts[mask].T).T + cam_x
        self.current_world = world
        for i, p in zip(ids[mask], world):
            i = int(i)
            self.lifetimes[i] = self.lifetimes.get(i, 0) + 1
            if self.lifetimes[i] > self.minimum_life:
                self.persistent[i] = p

    def _alignment(self):
        if len(self.gt_trail) >= 3 and len(self.trail) >= 3:
            n = min(len(self.gt_trail), len(self.trail))
            return umeyama_alignment(
                np.asarray(self.trail[:n]), np.asarray(self.gt_trail[:n])
            )
        return 1.0, np.eye(3), np.zeros(3)

    def render(self, path: str | None = None):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        s, R, t = self._alignment()
        apply = lambda p: (s * (R @ np.asarray(p).T)).T + t

        fig = plt.figure(figsize=(8, 8))
        ax = fig.add_subplot(projection="3d")
        if self.trail:
            trail = apply(np.asarray(self.trail))
            ax.plot(*trail.T, color="tab:blue", label="estimate")
        if self.gt_trail:
            ax.plot(*np.asarray(self.gt_trail).T, "--", color="k", label="ground truth")
        if self.persistent:
            pp = apply(np.asarray(list(self.persistent.values())))
            ax.scatter(*pp.T, s=3, color="0.4", label="map points")
        if len(self.current_world):
            cw = apply(self.current_world)
            ax.scatter(*cw.T, s=12, color="gold", label="live landmarks")
        if self.last_pose is not None:
            Rp, xp = self.last_pose
            xp = apply(xp)
            for k, c in enumerate("rgb"):
                d = s * (R @ Rp[:, k]) * 0.5
                ax.plot(*np.stack([xp, xp + d]).T, color=c, linewidth=2)
        ax.legend(fontsize=8)
        if path:
            fig.savefig(path, dpi=120, bbox_inches="tight")
            plt.close(fig)
            return path
        return fig


class LiveDisplayServer:
    """Localhost LIVE map viewer: the runtime equivalent of the reference's
    GLUT 3-D plotter (``libs/visualisation/include/Plotter.h:29-108`` and the
    live display loop in ``VIOVisualiser.cpp:139-228``), redesigned for
    headless/remote hosts: instead of an OpenGL window, a background
    stdlib HTTP server renders the accumulated :class:`MapDisplay` on demand
    and serves an auto-refreshing page at ``http://127.0.0.1:PORT/``.

    Zero external dependencies, zero cost when no client is connected (the
    figure renders only on request); ``update()`` is the per-frame hook and
    is safe to call from the pipeline's writer thread.
    """

    def __init__(self, display: MapDisplay | None = None, port: int = 8642):
        import http.server
        import threading

        self.display = display or MapDisplay()
        self._lock = threading.Lock()
        self.frames = 0
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence per-request stderr lines
                pass

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    body = (
                        "<!doctype html><title>eqvio_tpu live</title>"
                        "<body style='background:#111;color:#ddd;"
                        "font-family:monospace'>"
                        "<h3>eqvio_tpu live map</h3>"
                        "<div id=s></div><img id=m src=/map.png width=720>"
                        "<script>setInterval(()=>{m.src='/map.png?'+Date.now();"
                        "fetch('/status.json').then(r=>r.json()).then(j=>"
                        "s.textContent='frame '+j.frames+' @ t='+j.t);},1000);"
                        "</script></body>"
                    ).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path.startswith("/map.png"):
                    import io

                    buf = io.BytesIO()
                    with server._lock:
                        fig = server.display.render()
                        fig.savefig(buf, format="png", dpi=100,
                                    bbox_inches="tight")
                        import matplotlib.pyplot as plt

                        plt.close(fig)
                    body = buf.getvalue()
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path.startswith("/status.json"):
                    import json as _json

                    with server._lock:
                        t = server.display.times[-1] if server.display.times else 0.0
                        body = _json.dumps(
                            {"frames": server.frames, "t": round(t, 3)}
                        ).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_error(404)

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def update(self, *args, **kwargs):
        with self._lock:
            self.display.update(*args, **kwargs)
            self.frames += 1

    def close(self):
        self.httpd.shutdown()
