"""Tiny versions of the benchmark's cells for the CPU: the same files, the
scene cut to a few pixels and triangles, the plain kernels."""

from benchmark import core

SIZES = {"cornell_box": dict(width=24, height=24),
         "procedural_interior": dict(width=64, height=36, n_tris=4000)}


def cell(name: str, spp: int = 2, check_pixels: int = 128):
    c = core.Cell(name)
    c.config.update(SIZES[c.config["geometry"]])
    c.config["render_options"]["chunk_size"] = 512
    c.traffic["render_options"]["spp"] = spp
    c.traffic["check_pixels"] = check_pixels
    c.traffic["supervised_pixels"] = check_pixels
    return c


def run(c, seed=2**31 + 77, seconds=0.3, trace=False):
    r = core.Run(c, seed, seconds, trace, device="cpu")
    try:
        return core.execute(r)
    finally:
        r.cleanup()
