"""Command-line interface.

The reference has no CLI — every experiment is an interactively-invoked ROOT
macro with hand-edited parameter packs (SURVEY.md §5.6).  This CLI gives each
reference entry point a subcommand with the same knobs and defaults:

  altair-tpu fluxmap        <- sweepDetectorTraceOnce / sweepDetector
  altair-tpu series         <- sweepSeries (port-angle / repeat series)
  altair-tpu distribution   <- distributionSphereDetectorSweep + NRays count
  altair-tpu insphere       <- integratingSphereDetectorSweep
  altair-tpu visualize      <- visualizeDetector (PNG instead of OpenGL)
  altair-tpu analyze        <- flux_analysis.py
  altair-tpu scatter-retrace<- nonLambertianFlux sweepDetector

(The timing-footer benchmark lives at the repo root: ``python bench.py``.)
"""

from __future__ import annotations

import argparse
import sys


def _add_scene_args(p: argparse.ArgumentParser):
    p.add_argument("--port-angle", type=float, default=170.0,
                   help="exit-port angle thetaMax in degrees (default 170)")
    p.add_argument("--reflectance", type=float, default=0.99)
    p.add_argument("--roughness", type=float, default=0.01)
    p.add_argument("--max-bounces", type=int, default=50000)
    p.add_argument("--no-exact-rim", action="store_true",
                   help="disable the shell-rim face physics (~2x faster "
                        "tracing; exit fractions land at the top of the "
                        "corpus ranges instead of their centres)")
    p.add_argument("--surface", default="lambertian",
                   choices=["lambertian", "specular", "mixed", "cosn"])
    p.add_argument("--src", type=float, nargs=3, default=[-60.0, 0.0, -75.0],
                   metavar=("X", "Y", "Z"))
    p.add_argument("--dir", type=float, nargs=3, default=[5.0, 0.0, 0.0],
                   metavar=("DX", "DY", "DZ"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--qmc", type=int, default=0, choices=[0, 1, 2],
                   help="Sobol low-discrepancy draws in the direct "
                        "sampler: 1=digital shift, 2=Owen-scrambled "
                        "(~1/N accuracy on smooth observables; "
                        "docs/ENGINES.md)")


def _cfg(args):
    from .config import TraceConfig

    return TraceConfig(qmc=args.qmc)


def _mesh(args):
    """--mesh: a 1-D mesh over every visible device (multi-chip sweeps;
    SURVEY.md §2.4 — pure ray-axis data parallelism, one psum)."""
    if not getattr(args, "mesh", False):
        return None
    from .parallel import make_mesh

    return make_mesh()


def _add_mesh_arg(p: argparse.ArgumentParser):
    p.add_argument("--mesh", action="store_true",
                   help="shard the ray axis over all visible devices "
                        "(parallel.make_mesh); single-device runs are "
                        "unaffected without it")


def _scene_source(args):
    from .config import SphereScene, Source, SurfaceModel

    model = {"lambertian": SurfaceModel.LAMBERTIAN,
             "specular": SurfaceModel.SPECULAR,
             "mixed": SurfaceModel.MIXED_BRDF,
             "cosn": SurfaceModel.COS_N_LOBE}[args.surface]
    scene = SphereScene(
        theta_max_deg=args.port_angle, reflectance=args.reflectance,
        roughness=args.roughness, max_bounces=args.max_bounces,
        surface_model=model, exact_rim=not args.no_exact_rim)
    source = Source(x=args.src[0], y=args.src[1], z=args.src[2],
                    dir_x=args.dir[0], dir_y=args.dir[1], dir_z=args.dir[2])
    return scene, source


def cmd_fluxmap(args):
    from .config import DetectorGrid
    from .sweep import sweep_detector_retrace, sweep_detector_trace_once

    scene, source = _scene_source(args)
    cfg = _cfg(args)
    grid = DetectorGrid(n_theta=args.theta_bins, n_phi=args.phi_bins,
                        width=args.detector_size, height=args.detector_size)
    if args.replicates > 1:
        if args.method != "trace-once":
            raise SystemExit("--replicates applies to --method trace-once")
        import numpy as np

        from .sweep import fluxmap_replicates

        mean, sem = fluxmap_replicates(
            scene, source, n_rays=args.rays, grid=grid,
            replicates=args.replicates, seed=args.seed, cfg=cfg)
        bright = mean > mean.max() * 0.1
        print(f"{args.replicates} replicates x {args.rays} rays: "
              f"pooled bright-cell sem "
              f"{sem[bright].mean():.3e} (rel "
              f"{(sem[bright] / np.maximum(mean[bright], 1e-12)).mean():.3%})")
        if args.out:
            import os

            from .io import FluxmapWriter, fluxmap_filename

            fname = fluxmap_filename(
                args.rays * args.replicates, grid.n_theta, grid.n_phi,
                (float(source.x), float(source.y), float(source.z)),
                trace_once=True)
            from .sweep.observer import _metadata

            meta = _metadata(scene, source, grid,
                             args.rays * args.replicates, trace_once=True)
            with FluxmapWriter(os.path.join(args.out, fname), meta) as w:
                w.write_map(np.asarray(grid.theta_centers()),
                            np.asarray(grid.phi_centers()), mean)
                path = w.path
            print(f"mean flux map saved to '{path}'")
        return 0
    if args.method == "trace-once":
        res = sweep_detector_trace_once(
            scene, source, n_rays=args.rays, grid=grid, seed=args.seed,
            cfg=cfg, save_folder=args.out, notify=args.notify,
            mesh=_mesh(args))
    else:
        res = sweep_detector_retrace(
            scene, source, n_rays_per_pos=args.rays, grid=grid,
            seed=args.seed, cfg=cfg, save_folder=args.out,
            notify=args.notify, resume_path=args.resume,
            engine=args.retrace_engine, oversample=args.oversample,
            mesh=_mesh(args))
    print(f"total {res.total_time_s:.3f}s  trace {res.trace_time_s:.3f}s")
    return 0


def cmd_series(args):
    scene, source = _scene_source(args)
    src_xs = getattr(args, "source_xs", None)
    if args.vmapped:
        import numpy as np

        from .sweep import run_series_vmapped

        if src_xs is not None:
            import jax.numpy as jnp

            from .sweep import stack_sources

            # cross port_angles x source positions exactly like the
            # sequential path (one vmapped device call per port; the
            # source axis is the batched one)
            per_port = []
            for port in args.port_angles:
                counts, exits = run_series_vmapped(
                    scene.with_(theta_max_deg=float(port)),
                    sources=stack_sources(source, x=jnp.asarray(src_xs)),
                    n_rays=args.rays, cfg=_cfg(args))
                for x, e in zip(src_xs, exits):
                    print(f"port {port} srcX {x}: exit fraction "
                          f"{e / args.rays:.4f}")
                per_port.append(counts)
            counts = np.stack(per_port)  # [n_ports, n_src, n_theta, n_phi]
        else:
            counts, exits = run_series_vmapped(
                scene, source, port_angles=args.port_angles,
                n_rays=args.rays, cfg=_cfg(args))
            for p, e in zip(args.port_angles, exits):
                print(f"port {p}: exit fraction {e / args.rays:.4f}")
        import os

        os.makedirs(args.out, exist_ok=True)
        out_path = os.path.join(args.out, "series_fluxmaps.npy")
        np.save(out_path, counts)
        print(f"fluxmaps saved to {out_path}")
    else:
        from .sweep import run_series

        run_series(scene, source, port_angles=args.port_angles,
                   sources=(None if src_xs is None else
                            [source.with_(x=float(x)) for x in src_xs]),
                   repeats=args.repeats, n_rays=args.rays,
                   save_root=args.out, cfg=_cfg(args))
    return 0


def cmd_distribution(args):
    from .sweep import run_distribution, write_angular_dist, write_ray_log

    scene, source = _scene_source(args)
    d = run_distribution(scene, source, n_rays=args.rays, seed=args.seed,
                         cfg=_cfg(args), mesh=_mesh(args))
    print(f"Flux of rays through the exit port: {d.n_exited}")
    if args.ray_log:
        write_ray_log(args.ray_log, d.directions)
    if args.angular_dist:
        write_angular_dist(args.angular_dist, d.dz_hist)
    return 0


def cmd_insphere(args):
    from .sweep import sweep_insphere_detector

    scene, source = _scene_source(args)
    scene = scene.with_(outer_radius=105.0, world_half=200.0)
    r = sweep_insphere_detector(
        scene, source, disk_radius=args.disk_radius, n_rays=args.rays,
        dtheta=args.dtheta, theta_max=args.theta_max,
        save_path=args.out_file, retrace=args.retrace, cfg=_cfg(args),
        mesh=_mesh(args))
    print(f"{len(r.thetas)} positions in {r.wall_time_s:.2f}s -> "
          f"{args.out_file}")
    return 0


def cmd_visualize(args):
    from .viz import export_html, plot_rays, print_census, trace_paths

    scene, source = _scene_source(args)
    paths = trace_paths(scene, source, n_rays=args.rays, seed=args.seed,
                        detector_theta=args.det_theta,
                        detector_phi=args.det_phi)
    print_census(paths, args.rays)
    if args.out_file.endswith(".html"):
        export_html(paths, scene, args.out_file,
                    only_show_red=args.only_red)
    else:
        plot_rays(paths, scene, only_show_red=args.only_red,
                  save_path=args.out_file)
    print(f"saved {args.out_file}")
    return 0


def cmd_scatter_retrace(args):
    import numpy as np

    from .config import DetectorGrid
    from .sweep import sweep_scatter_retrace

    scene, source = _scene_source(args)
    scene = scene.with_(specular_prob=args.specular, diffuse_prob=args.diffuse,
                        brdf_roughness=args.brdf_roughness)
    grid = DetectorGrid(n_theta=args.theta_bins, n_phi=args.phi_bins,
                        width=args.detector_size, height=args.detector_size)
    sw = sweep_scatter_retrace(scene, source, n_rays=args.rays, grid=grid,
                               seed=args.seed, cfg=_cfg(args),
                               mesh=_mesh(args))
    np.savetxt(args.out_file,
               np.column_stack([
                   np.repeat((np.arange(grid.n_theta) + 0.5)
                             * (grid.theta_hi - grid.theta_lo)
                             / grid.n_theta, grid.n_phi),
                   np.tile((np.arange(grid.n_phi) + 0.5)
                           * (grid.phi_hi - grid.phi_lo) / grid.n_phi,
                           grid.n_theta),
                   sw.fluxmap.ravel()]),
               fmt="%.6f", delimiter=",", header="theta,phi,fraction",
               comments="")
    print(f"{grid.n_positions} positions in {sw.wall_time_s:.2f}s -> "
          f"{args.out_file}")
    return 0


def cmd_analyze(args):
    from .analysis import analyze

    analyze(args.path, average_mode=args.average)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="altair-tpu",
        description="GPU integrating-sphere photon tracer")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("fluxmap", help="observer flux-map sweep")
    _add_scene_args(p)
    _add_mesh_arg(p)
    p.add_argument("--method", choices=["trace-once", "retrace"],
                   default="trace-once")
    p.add_argument("--rays", type=int, default=100_000,
                   help="total rays (trace-once) or rays per position")
    p.add_argument("--theta-bins", type=int, default=180)
    p.add_argument("--phi-bins", type=int, default=90)
    p.add_argument("--detector-size", type=float, default=40.0)
    p.add_argument("--out", default="results")
    p.add_argument("--resume", default=None,
                   help="partial CSV from a killed retrace run")
    p.add_argument("--retrace-engine", choices=["simulate", "binomial"],
                   default="simulate",
                   help="binomial: per-cell retrace statistics sampled "
                        "from one shared trace (means exact, 1/oversample "
                        "excess variance — docs/PARITY.md §9)")
    p.add_argument("--oversample", type=int, default=128,
                   help="shared-sample factor for the binomial engine")
    p.add_argument("--replicates", type=int, default=1,
                   help=">1: run K independent trace-once maps in one "
                        "device call and report the mean map with "
                        "per-cell error bars (sweep.fluxmap_replicates; "
                        "with --qmc each replicate is an independent "
                        "Sobol randomisation)")
    p.add_argument("--notify", action="store_true")
    p.set_defaults(fn=cmd_fluxmap)

    p = sub.add_parser("series", help="port-angle / repeat sweep series")
    _add_scene_args(p)
    p.add_argument("--port-angles", type=float, nargs="+",
                   default=[164.0])
    p.add_argument("--source-xs", type=float, nargs="+", default=None,
                   help="sweep the SOURCE x position instead of the port "
                        "angle (the srcX axis of sweepSeries, "
                        "fluxAtObserverOptimize.C:892-921); with "
                        "--vmapped all positions run in one device call")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--rays", type=int, default=100_000)
    p.add_argument("--out", default=".")
    p.add_argument("--vmapped", action="store_true",
                   help="run all series members in one device call (vmap "
                        "over the scene batch axis) instead of the "
                        "reference's sequential loop")
    p.set_defaults(fn=cmd_series)

    p = sub.add_parser("distribution", help="exit angular distribution")
    _add_scene_args(p)
    _add_mesh_arg(p)
    p.add_argument("--rays", type=int, default=10_000)
    p.add_argument("--ray-log", default=None,
                   help="write 3dRayLog.txt-dialect directions here")
    p.add_argument("--angular-dist", default=None,
                   help="write angular_dist.txt-dialect histogram here")
    p.set_defaults(fn=cmd_distribution)

    p = sub.add_parser("insphere", help="in-sphere detector-disk sweep")
    _add_scene_args(p)
    _add_mesh_arg(p)
    p.add_argument("--rays", type=int, default=100_000)
    p.add_argument("--disk-radius", type=float, default=5.0)
    p.add_argument("--dtheta", type=float, default=0.5)
    p.add_argument("--theta-max", type=float, default=45.0)
    p.add_argument("--retrace", action="store_true",
                   help="re-trace per position (reference methodology)")
    p.add_argument("--out-file", default="detector_sweep3.txt")
    p.set_defaults(fn=cmd_insphere)

    p = sub.add_parser("visualize", help="ray-path classification plot")
    _add_scene_args(p)
    p.add_argument("--rays", type=int, default=100)
    p.add_argument("--det-theta", type=float, default=45.0)
    p.add_argument("--det-phi", type=float, default=0.0)
    p.add_argument("--only-red", action="store_true",
                   help="showRedRaysOnly mode")
    p.add_argument("--out-file", default="rays.png",
                   help="output image; a .html extension writes the "
                        "interactive drag-to-rotate viewer instead")
    p.set_defaults(fn=cmd_visualize)

    p = sub.add_parser("scatter-retrace",
                       help="two-stage BRDF scatter-retrace sweep "
                            "(nonLambertianFlux methodology)")
    _add_scene_args(p)
    _add_mesh_arg(p)
    p.add_argument("--rays", type=int, default=100_000)
    p.add_argument("--theta-bins", type=int, default=45)
    p.add_argument("--phi-bins", type=int, default=20)
    p.add_argument("--detector-size", type=float, default=10.0)
    p.add_argument("--specular", type=float, default=0.4)
    p.add_argument("--diffuse", type=float, default=0.6)
    p.add_argument("--brdf-roughness", type=float, default=0.3)
    p.add_argument("--out-file", default="fluxmap_data.csv")
    p.set_defaults(fn=cmd_scatter_retrace)

    p = sub.add_parser("analyze", help="flux-map analysis/plots")
    p.add_argument("path")
    p.add_argument("--average", action="store_true")
    p.set_defaults(fn=cmd_analyze)

    args = ap.parse_args(argv)
    from .compile_cache import enable_compile_cache

    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
