"""Generate the full-length hermetic proxy datasets (V1_01 + racing + MH_03 +
distractor).

CPU-only work:
    JAX_PLATFORMS=cpu python scripts/make_proxies.py
"""

import os
import sys
import time

ROOT = "/tmp/eqvio_proxies"


def main():
    from eqvio_tpu.data.synthetic import (
        generate_distractor_proxy,
        generate_mh03_proxy,
        generate_racing_proxy,
        generate_v101_proxy,
    )

    t0 = time.time()
    v101 = os.path.join(ROOT, "v101")
    if not os.path.exists(os.path.join(v101, "proxy_info.yaml")):
        print("generating v101 proxy (144 s, 752x480 @ 20 Hz)...", flush=True)
        _, stats = generate_v101_proxy(v101)
        print(f"  {stats}", flush=True)
    racing = os.path.join(ROOT, "racing")
    if not os.path.exists(os.path.join(racing, "proxy_info.yaml")):
        print("generating racing proxy (60 s, 640x480 @ 30 Hz)...", flush=True)
        _, stats = generate_racing_proxy(racing)
        print(f"  {stats}", flush=True)
    mh03 = os.path.join(ROOT, "mh03")
    if not os.path.exists(os.path.join(mh03, "proxy_info.yaml")):
        print("generating mh03 proxy (132 s, 752x480 @ 20 Hz)...", flush=True)
        _, stats = generate_mh03_proxy(mh03)
        print(f"  {stats}", flush=True)
    dis = os.path.join(ROOT, "distractor")
    if not os.path.exists(os.path.join(dis, "proxy_info.yaml")):
        print("generating distractor proxy (45 s, 752x480 @ 20 Hz)...", flush=True)
        _, stats = generate_distractor_proxy(dis)
        print(f"  {stats}", flush=True)
    print(f"done in {time.time() - t0:.0f} s", flush=True)


if __name__ == "__main__":
    sys.exit(main())
