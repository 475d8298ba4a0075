"""Break a ``chip_smoke.py`` run's wall time down by the lines it prints.

    python3 tools/phase_times.py OUT.json -- python3 chip_smoke.py [args]

Runs the command, passes its standard output through unchanged, and
charges each line the seconds since the line before it (the first line,
the seconds since the start).  A JSON line is charged to its ``phase``
field, with its ``cell``, ``path`` or ``name`` after a slash where it has
one (``compressed/compressed_tpch_q1``); any other line to ``(text)``.
Writes ``{"rc", "seconds", "by_line": {key: seconds}}`` to OUT.json,
largest first, and exits with the command's code.
"""

import json
import subprocess
import sys
import time


def line_key(text: str) -> str:
    try:
        obj = json.loads(text)
    except ValueError:
        return "(text)"
    if not isinstance(obj, dict) or "phase" not in obj:
        return "(text)"
    for sub in ("cell", "path", "name"):
        if isinstance(obj.get(sub), str):
            return f"{obj['phase']}/{obj[sub]}"
    return str(obj["phase"])


def main(argv) -> int:
    if len(argv) < 3 or argv[1] != "--":
        print(__doc__, file=sys.stderr)
        return 2
    out_path, cmd = argv[0], argv[2:]
    by_line = {}
    t0 = last = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                            bufsize=1)
    for text in proc.stdout:
        sys.stdout.write(text)
        sys.stdout.flush()
        now = time.perf_counter()
        key = line_key(text)
        by_line[key] = by_line.get(key, 0.0) + now - last
        last = now
    rc = proc.wait()
    total = time.perf_counter() - t0
    with open(out_path, "w") as f:
        json.dump({"rc": rc, "seconds": total, "by_line": dict(sorted(
            by_line.items(), key=lambda kv: -kv[1]))}, f, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
