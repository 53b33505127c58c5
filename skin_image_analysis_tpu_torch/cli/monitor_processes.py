"""Process and fd diagnostics CLI (counterpart of the JAX package's
``cli.monitor_processes``)::

    python -m skin_image_analysis_tpu_torch.cli.monitor_processes \\
        [--verbose] [--watch SECONDS]

Prints the fd and memory figures of every live python process;
``--watch`` repeats them every SECONDS. Needs psutil.
"""

from __future__ import annotations

import sys
import time

from skin_image_analysis_tpu_torch.cli._common import parse
from skin_image_analysis_tpu_torch.utils.monitor import print_python_processes


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    _, opts = parse(argv, {"watch": 0.0}, bool_flags={"verbose"})
    while True:
        print(f"--- {time.strftime('%H:%M:%S')} ---")
        print_python_processes(verbose=opts["verbose"])
        if not opts["watch"]:
            break
        time.sleep(opts["watch"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
