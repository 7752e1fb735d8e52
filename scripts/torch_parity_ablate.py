#!/usr/bin/env python3
"""Where the parity day-march kernel's time goes, by ablation: copies of
this checkout's heatx_torch, each with one part of the parity sub-step
(csrc/day_march_parity.cu) cut out, timed against the whole kernel on the
bench city's f32 parity day-launch in one command.  The cut copies compute
wrong temperatures: they measure time only.  Run from the repository root
on a card:

    python3 scripts/torch_parity_ablate.py [CUT ...]

It writes each copy to build/ablate/<cut> (build/ is not committed) and
runs ``scripts/torch_launch_ab.py --march-only --only "bench parity"`` over
the whole kernel and the copies in turns (whole, copies..., copies...,
whole).  The cuts (all by default):

  face1   the first film evaluation of a sub-step (films and radiation of the
          start state) replaced by constants
  face2   the second film evaluation (the new column's films) dropped
  nomass  the no-mass solve dropped (one iteration: the column unchanged)
  rk4     the four RK4 stages dropped (k = qs)
  zone    the zone sums and update dropped (the two barriers stay)
  zone_sums    the zone sums alone dropped (each zone reads one face)
  zone_update  the free-float zone update alone dropped (a product instead)
"""

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SRC = "heatx_torch/csrc/day_march_parity.cu"

# cut -> (text in the kernel, its replacement)
CUTS = {
    "face1": ("""      const FaceOps<T> fo =
          parity_face_ops<T, kMrt>(L, back, ts_f, ts_b, t_front, t_back, rad_out, base, a.amb_bug, me, tm);""",
              """      const FaceOps<T> fo{T(5), T(5), t_front};"""),
    "face2": ("""      const T h2 = parity_face_h(L, back, back ? t_back : t_front,
                                 parity_face_surf(L, back, ts_f, ts_b, a.amb_bug), base);""",
              """      const T h2 = fo.h;"""),
    "nomass": ("""        T x[M];
        nomass_solve(Tn, x);""", """        T x[M];
#pragma unroll
        for (int j = 0; j < M; ++j) x[j] = Tn[j];"""),
    "rk4": ("""      stage(Tn);""", """#pragma unroll
      for (int j = 0; j < M; ++j) kk[j] = qs[j];"""),
    "zone": ("""      for (int z = by_warp ? tid >> 5 : tid; z < ZB; z += zstep) {
        const int gz = b * ZB + z;""", """      for (int z = ZB; z < ZB; z += zstep) {
        const int gz = b * ZB + z;"""),
    "zone_sums": ("""        if (by_warp)
          zone_sums_warp(s_zptr, s_zf, z, tid & 31, s_haT, s_ha, s_ga[z], s_gb[z], az, bz);
        else
          zone_sums_shared(s_zptr, s_zf, z, s_haT, s_ha, s_ga[z], s_gb[z], az, bz);""",
                  """        az = s_ga[z] + s_haT[2 * z];
        bz = s_gb[z] + s_ha[2 * z];"""),
    "zone_update": ("""          s_zT[z] = zone_update(s_zT[z], az, bz, s_vol[z], dt);""",
                    """          s_zT[z] = s_zT[z] + T(1e-12) * (az + bz);"""),
}


def main() -> int:
    cuts = sys.argv[1:] or list(CUTS)
    trees = []
    for cut in cuts:
        old, new = CUTS[cut]
        dst = ROOT / "build" / "ablate" / cut
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(ROOT / "heatx_torch", dst / "heatx_torch", ignore=shutil.ignore_patterns("_build"))
        shutil.copy(ROOT / "chip_smoke.py", dst / "chip_smoke.py")
        text = (dst / SRC).read_text()
        if old not in text:
            raise SystemExit(f"torch_parity_ablate: the {cut} cut does not match {SRC}")
        text = text.replace(old, new)
        if cut == "rk4":  # all four stages
            text = text.replace("      stage(y);", new)
        (dst / SRC).write_text(text)
        trees.append(str(dst))
    args = [sys.executable, str(ROOT / "scripts" / "torch_launch_ab.py"), "--march-only", "--only", "bench parity",
            str(ROOT), *trees, *trees, str(ROOT)]
    return subprocess.call(args, cwd=ROOT)


if __name__ == "__main__":
    sys.exit(main())
