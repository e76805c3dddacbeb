"""One ``render`` CLI replacing the reference's five example mains.

The reference ships five binaries each hard-coding resolution/spp/depth/
camera/scene/integrator and ignoring argv entirely (reference:
Src/examples/example.cpp:19-103 etc.; SURVEY.md §2.3). Here a single entry
point selects a preset and lets every knob be overridden:

    python -m xraytracer.cli --preset cornellbox_gi --spp 64 -o out.png
"""

import argparse
import contextlib
import sys
import time

from .camera import PinholeCamera
from .config import PRESETS, get_preset
from .film import write_image
from .integrators import (
    make_direct_integrator,
    make_furnace_integrator,
    make_normal_integrator,
    make_path_integrator,
    make_volume_integrator,
    make_whitted_integrator,
)
from .renderer import Accumulator, default_mesh, pixel_sharding, render
from .scene.builder import scene_statics
from .scene import presets as scene_presets


def build_scene(cfg, density_grid=None):
    """Preset name (or --obj path) -> (tables, camera_kwargs)."""
    if cfg.obj:
        from .scene.builder import SceneBuilder
        from .scene.objloader import load_obj_into
        from .scene.presets import cornell_camera

        b = SceneBuilder()
        load_obj_into(b, cfg.obj)
        return b.build(), cornell_camera()
    if density_grid and cfg.preset in ("volume", "nee"):
        # replace the procedural stand-in cloud with a converted grid
        # (reference analogue: the NanoVDBConvert offline tool feeding
        # examples/volume.cpp; here: tools/grid_convert.py -> .npy)
        import numpy as np

        loaded = np.load(density_grid)
        if isinstance(loaded, np.lib.npyio.NpzFile):
            key = "density" if "density" in loaded else loaded.files[0]
            loaded = loaded[key]
        density = loaded.astype("float32")
        from .scene.presets import build_volume_scene

        kwargs = (
            dict(absorption=(0.01,) * 3, scattering=(0.05,) * 3, le=30.0,
                 light_center=(0.0, 400.0, 0.0))
            if cfg.preset == "nee" else {}
        )
        tables = build_volume_scene(density=density, **kwargs).build()
        from .math import from_rows

        c2w = from_rows(
            1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0, 0, 70.0, 550.0, 1
        )
        return tables, dict(c2w=c2w, fov_deg=60.0)
    fn = getattr(scene_presets, f"preset_{cfg.preset}")
    tables, cam_kwargs, _ = fn()
    return tables, cam_kwargs


def make_integrator(cfg, tables, statics, with_stats=False):
    if cfg.integrator == "normal":
        return make_normal_integrator(tables)
    if cfg.integrator == "furnace":
        return make_furnace_integrator(
            tables, cosine_sampling=cfg.cosine_sampling
        )
    if cfg.integrator == "direct":
        return make_direct_integrator(tables, statics)
    if cfg.integrator == "indirect":
        return make_path_integrator(
            tables, statics, cfg.max_depth, nee=False,
            cosine_sampling=cfg.cosine_sampling, with_stats=with_stats,
        )
    if cfg.integrator == "gi":
        return make_path_integrator(
            tables, statics, cfg.max_depth, nee=True,
            cosine_sampling=cfg.cosine_sampling, with_stats=with_stats,
            nee_mode=cfg.nee_mode,
        )
    if cfg.integrator == "gi_mis":
        return make_path_integrator(
            tables, statics, cfg.max_depth, mis=True,
            cosine_sampling=cfg.cosine_sampling, with_stats=with_stats,
            nee_mode=cfg.nee_mode,
        )
    if cfg.integrator == "whitted":
        return make_whitted_integrator(tables, statics, cfg.max_depth)
    if cfg.integrator == "vpt":
        return make_volume_integrator(
            tables, statics, cfg.max_depth, nee=False,
            max_steps=cfg.max_steps or None, with_stats=with_stats,
        )
    if cfg.integrator == "vpt_nee":
        return make_volume_integrator(
            tables, statics, cfg.max_depth, nee=True,
            max_steps=cfg.max_steps or None, with_stats=with_stats,
        )
    raise ValueError(f"unknown integrator {cfg.integrator!r}")


def run(argv=None):
    """Parse ``argv``, render, write the image; return the RenderResult."""
    p = argparse.ArgumentParser(
        prog="xraytracer",
        description="Differentiable Monte-Carlo path tracer",
    )
    p.add_argument("--preset", choices=sorted(PRESETS), default="cornellbox")
    p.add_argument("--integrator", default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--spp", type=int, default=None)
    p.add_argument("--max-depth", type=int, default=None, dest="max_depth")
    p.add_argument("--gamma", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--spp-chunk", type=int, default=None, dest="spp_chunk")
    p.add_argument("--max-steps", type=int, default=None, dest="max_steps",
                   help="tracking-loop step bound for volume integrators")
    p.add_argument("--nee-mode", default=None, dest="nee_mode",
                   choices=("all", "one", "power"),
                   help="NEE light selection: sum all lights (reference "
                        "semantics), one uniform pick, or power-weighted "
                        "pick (many-light scenes)")
    p.add_argument("--cosine", action="store_true", default=None,
                   dest="cosine_sampling",
                   help="cosine-weighted Lambert sampling (lower variance)")
    p.add_argument("--shard", action="store_true", default=None,
                   help="shard the pixel axis over all local devices")
    p.add_argument("--checkpoint", default=None,
                   help=".npz path for chunked accumulation checkpoints")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint if it exists")
    p.add_argument("--obj", default=None, help="render an .obj scene file")
    p.add_argument("--density-grid", default=None, dest="density_grid",
                   help=".npy dense density grid for the volume/nee presets")
    p.add_argument("--profile", default=None,
                   help="directory for a jax.profiler trace of the render")
    p.add_argument("--stats", action="store_true",
                   help="collect + print per-bounce ray/occupancy/RR metrics"
                        " (SURVEY.md §5; path and volume integrators)")
    p.add_argument("-o", "--output", default=None)
    args = p.parse_args(argv)

    from .compile_cache import enable_compile_cache

    enable_compile_cache()

    cfg = get_preset(
        args.preset,
        integrator=args.integrator, width=args.width, height=args.height,
        spp=args.spp, max_depth=args.max_depth, gamma=args.gamma,
        seed=args.seed, spp_chunk=args.spp_chunk, max_steps=args.max_steps,
        cosine_sampling=args.cosine_sampling, shard=args.shard,
        checkpoint=args.checkpoint, obj=args.obj, output=args.output,
        nee_mode=args.nee_mode,
    )

    tables, cam_kwargs = build_scene(cfg, density_grid=args.density_grid)
    statics = scene_statics(tables)
    camera = PinholeCamera.make(cfg.width / cfg.height, **cam_kwargs)
    integrate = make_integrator(cfg, tables, statics, with_stats=args.stats)

    sharding = None
    if cfg.shard:
        sharding = pixel_sharding(default_mesh())

    accumulator = None
    if args.resume and cfg.checkpoint:
        import os

        if os.path.exists(cfg.checkpoint):
            accumulator = Accumulator.load(cfg.checkpoint)
            print(f"resuming from {cfg.checkpoint} at spp {accumulator.spp_done}")

    print(
        f"[render] preset={cfg.preset} integrator={cfg.integrator} "
        f"{cfg.width}x{cfg.height} spp={cfg.spp} depth={cfg.max_depth}"
    )
    t0 = time.perf_counter()
    if args.profile:
        import jax

        trace_cm = jax.profiler.trace(args.profile)
    else:
        trace_cm = contextlib.nullcontext()
    with trace_cm:
        result = render(
            tables, camera, integrate, cfg.width, cfg.height, cfg.spp,
            seed=cfg.seed, spp_chunk=cfg.spp_chunk or None,
            accumulator=accumulator, checkpoint_path=cfg.checkpoint,
            sharding=sharding,
        )
    print(
        f"[render] done in {result.seconds:.2f}s "
        f"({result.samples_per_sec/1e6:.2f} Msamples/s, "
        f"{result.n_rejected} rejected)"
    )
    if result.stats is not None:
        st = result.stats
        n_lanes = cfg.width * cfg.height * cfg.spp
        print(f"[stats] total rays traced: {result.total_rays}"
              f" ({result.total_rays / max(result.seconds, 1e-9) / 1e6:.2f}"
              " Mrays/s incl. shadow)")
        rays = st["rays"]
        for b in range(len(rays)):
            parts = [f"depth {b}: rays={int(rays[b])}",
                     f"occupancy={int(rays[b]) / max(n_lanes, 1):.3f}"]
            if "shadow_rays" in st:
                parts.append(f"shadow={int(st['shadow_rays'][b])}")
            if "scattered" in st:
                parts.append(f"scattered={int(st['scattered'][b])}")
            rr = int(st["rr_killed"][b])
            survivors = int(rays[b]) - rr
            parts.append(f"rr_survival={survivors / max(int(rays[b]), 1):.3f}")
            parts.append(f"active_out={int(st['active_out'][b])}")
            print("[stats] " + " ".join(parts))
    write_image(cfg.output, result.image, gamma=cfg.gamma)
    print(f"[render] wrote {cfg.output} (total {time.perf_counter()-t0:.2f}s)")
    return result


def main(argv=None):
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
