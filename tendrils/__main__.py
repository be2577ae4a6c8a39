"""CLI runner — the headless analog of `src/demo-run.main.js` (boot the demo
on load) plus the export path the browser build lacks.

    python -m tendrils [--preset NAME] [--frames N] [--out DIR]
                       [--res HxW] [--root N] [--setting key=value ...]

Runs the demo app headlessly and writes PNG frames (and a final
checkpoint), replaying any preset deterministically at the fixed timestep.
"""

import argparse
import json
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tendrils", description=__doc__)
    ap.add_argument("--preset", default=None, help="preset name to apply")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--out", default="out", help="output directory")
    ap.add_argument("--res", default="720x1280", help="HxW view resolution")
    ap.add_argument("--root", type=int, default=None,
                    help="rootNum (particles = rootNum^2); default by "
                         "quality tier")
    ap.add_argument("--every", type=int, default=1,
                    help="write every Nth frame")
    ap.add_argument("--quality", type=int, default=0)
    ap.add_argument("--checkpoint", default=None,
                    help="resume from this checkpoint before running")
    ap.add_argument("--list-presets", action="store_true")
    ap.add_argument("--setting", action="append", default=[],
                    metavar="KEY=VALUE", help="querystring-style setting")
    args = ap.parse_args(argv)

    from tendrils.app import PRESETS, TendrilsDemo
    from tendrils.compile_cache import enable_compile_cache
    from tendrils.io import save_checkpoint, save_png, view_to_u8
    from tendrils.models.configs import SAMPLING

    if args.list_presets:
        print("\n".join(PRESETS))
        return 0

    enable_compile_cache()

    h, w = (int(v) for v in args.res.split("x"))
    settings = dict(s.split("=", 1) for s in args.setting)
    settings.setdefault("quality", str(args.quality))
    if args.preset:
        settings["preset"] = args.preset

    kw = dict(view_res=(h, w), **SAMPLING)
    if args.root:
        kw["root_num"] = args.root
    demo = TendrilsDemo(settings, **kw)
    if args.root:
        demo.quality["options"][demo.quality["level"]]["rootNum"] = args.root
        demo.quality_change(demo.quality["level"])
        if args.preset:
            demo.apply_preset(args.preset)

    os.makedirs(args.out, exist_ok=True)
    t0 = time.time()
    for i in range(args.frames):
        demo.render()
        if i % args.every == 0:
            import numpy as np
            img = view_to_u8(np.asarray(demo.screen_image))
            save_png(os.path.join(args.out, f"frame_{i:05d}.png"), img)
    elapsed = time.time() - t0

    save_checkpoint(os.path.join(args.out, "final.ckpt.npz"), demo.tendrils)
    n = demo.tendrils.config.n
    print(json.dumps({
        "frames": args.frames,
        "particles": n,
        "ms_per_frame": round(elapsed / args.frames * 1000, 2),
        "particle_steps_per_sec": round(n * args.frames / elapsed),
        "out": args.out,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
