"""Where a launch of K21 or K13 spends its time: time stamps in a copy.

    python -m visual_sgraphs_tpu_torch.profile_stamps DIR
    env PYTHONPATH=DIR \
        python3 DIR/visual_sgraphs_tpu_torch/profile_stamps.py --read

The first form copies the package to ``DIR`` and inserts time stamps into
the copy's ``csrc/sg_assemble.cu`` and ``csrc/ransac.cu`` (the package
itself has none: a stamp costs a store and can change the registers a
kernel gets).  Each stamp records ``%globaltimer`` (ns, one clock for the
whole card) and ``clock64`` (cycles of the SM the stamping thread runs on):

- K21's system, thread 0 of every CTA: at entry, after the staging
  prologue, after the CTA's items, after its share of the fill, after the
  grid barrier and at exit; every live item's warp: the cycles of its
  linearisation and of its writes, with its type;
- K21's plan, thread 0 of the lists' CTA: between its steps (live items,
  variable counts, variable lists, coupled pairs, the counting walks, the
  offsets, the listing walks);
- K13, thread 0 of the cluster's first CTA, in every round: at its start,
  before the first cluster barrier (scored), after the winner, after the
  centroid, after the scatter, after the eigenvector, before the second
  cluster barrier (refit scored) and at its end.

The second form (by path, so that the copy's package is imported)
launches K21 on seeded operands (``selfcheck.sg_assemble_inputs``: every
factor type live; and again with a tenth of the plane observations live)
and K13 on the seeded keyframes
21 and 48 (``selfcheck.keyframe_inputs``), and prints one JSON line each:
the stamps' spans (the latest stamp over CTAs and the median, ns, from the
first entry; cycles between stamps, median and largest over CTAs), the
items' cycles by type, and device ms (``selfcheck.device_time``, stamps
included).  Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
from pathlib import Path

import numpy as np
import torch

PKG = Path(__file__).resolve().parent
TIMER = ("long long _gt; asm volatile(\"mov.u64 %0, %%globaltimer;\" : "
         "\"=l\"(_gt));")


def _stamp(arr: str, idx: str) -> str:
    return ("{ " + TIMER + f" {arr}[2 * ({idx})] = _gt; "
            f"{arr}[2 * ({idx}) + 1] = clock64(); }}")


def _insert(s: str, mark: str, before: str = "", after: str = "") -> str:
    """``s`` with ``before`` / ``after`` around the first ``mark``; raises
    when the source no longer holds it."""
    if mark not in s:
        raise ValueError(f"profile_stamps: source text not found: {mark!r}")
    return s.replace(mark, before + mark + after, 1)


def _stamp_k21(s: str) -> str:
    def sys_(k):
        return ("if (threadIdx.x == 0) "
                + _stamp("g_st_sys", f"blockIdx.x * 8 + {k}"))

    def plan(k):
        return ("__syncthreads(); if (threadIdx.x == 0) "
                + _stamp("g_st_plan", str(k)))

    s = _insert(s, "__device__ unsigned g_sg_bar[BAR_MAX_GROUPS + 2];\n",
                after="__device__ long long g_st_sys[2 * 8 * 2048];\n"
                "__device__ long long g_st_plan[2 * 16];\n"
                "__device__ long long g_st_item[3 * 4096];\n")
    head, body = s.split("sg_system_kernel(const __grid_constant__ "
                         "SysArgs a) {", 1)
    body = _insert(body, "    extern __shared__ double sh[];",
                   before="    " + sys_(0) + "\n")
    body = _insert(body, "    st.doors = doors;\n    __syncthreads();\n",
                   after="    " + sys_(1) + "\n")
    body = _insert(body, "        __syncwarp();\n    }\n",
                   after="    __syncthreads(); " + sys_(2) + "\n")
    body = _insert(body, "    grid_sync();\n",
                   before="    __syncthreads(); " + sys_(3) + "\n",
                   after="    " + sys_(4) + "\n")
    body = _insert(body, "        pair_sums(a, key, k0, k1, lane);\n    }\n",
                   after="    __syncthreads(); " + sys_(5) + "\n")
    s = head + "sg_system_kernel(const __grid_constant__ SysArgs a) {" + body
    item = s[s.index("__device__ void linearize_item("):
             s.index("// A warp: the block of the coupled pair")]
    new = _insert(item, "    const int i = a.live[n];",
                  before="    const long long _c0 = clock64();\n")
    new = _insert(new, "    lane_linearize(a, st, t, k, lane, rv, Jc);\n",
                  after="    const long long _c1 = clock64();\n")
    new = new.rstrip()[:-1] + (
        "    __syncwarp();\n    if (lane == 0 && n < 4096) { "
        "g_st_item[3 * n] = t; g_st_item[3 * n + 1] = _c1 - _c0; "
        "g_st_item[3 * n + 2] = clock64() - _c1; }\n}\n\n")
    s = s.replace(item, new)
    head, body = s.split("sg_plan_kernel(const __grid_constant__ "
                         "PlanArgs a) {", 1)
    for k, mark in enumerate((
            "    // 1. live items", "    // 2. each variable",
            "        const unsigned before = peers",
            "    // 3. the coupled pairs",
            "    // 4. each pair's contributors",
            "    int n_ent = 0;",
            "    for (int m = warp; m < n_pairs; m += PLAN_WARPS) {\n"
            "        const int key = a.pairs[m], k0")):
        if k == 2:
            # before the listing loop of step 2 (its second loop)
            loop = "    for (int b = lo; b < hi; b += 32) {\n"
            at = body.index(loop, body.index(loop) + 1)
            body = body[:at] + "    " + plan(k) + "\n" + body[at:]
            continue
        body = _insert(body, mark, before="    " + plan(k) + "\n")
    body = _insert(body, "        a.meta[1] = n_pairs;\n    }\n",
                   after="    " + plan(7) + "\n")
    s = head + "sg_plan_kernel(const __grid_constant__ PlanArgs a) {" + body
    return s + (
        "\nVSG_API int vsg_read_stamps_sg(long long* sys, long long* plan, "
        "long long* item) {\n"
        "    cudaError_t e = cudaMemcpyFromSymbol(sys, g_st_sys, "
        "sizeof(long long) * 2 * 8 * 2048);\n"
        "    if (e == cudaSuccess) e = cudaMemcpyFromSymbol(plan, g_st_plan, "
        "sizeof(long long) * 2 * 16);\n"
        "    if (e == cudaSuccess) e = cudaMemcpyFromSymbol(item, g_st_item, "
        "sizeof(long long) * 3 * 4096);\n"
        "    return (int)e;\n}\n")


def _stamp_k13(s: str) -> str:
    def rs(k):
        return ("if (threadIdx.x == 0 && c == 0) "
                + _stamp("g_st_rs", f"round * 8 + {k}"))

    s = _insert(s, "constexpr int TREES = PT / 32;\n",
                after="__device__ long long g_st_rs[2 * 8 * 8];\n")
    s = _insert(s, "        const int* hr = s_hyp + 3 * H * round;\n",
                after="        " + rs(0) + "\n")
    parts = s.split("        cl.sync();\n")
    if len(parts) != 3:
        raise ValueError("profile_stamps: ransac.cu's two cluster barriers "
                         "a round not found")
    s = (parts[0] + "        " + rs(1) + "\n        cl.sync();\n" + parts[1]
         + "        " + rs(6) + "\n        cl.sync();\n" + parts[2])
    for k, mark in ((2, "            const Plane win"),
                    (3, "            const float wsum"),
                    (4, "            if (tid == 0) {\n                "
                        "float sc6[6];"),
                    (5, "            // refit inlier score")):
        s = _insert(s, mark, before="            " + rs(k) + "\n")
    s = _insert(s, "    }\n    // no CTA leaves",
                before="        " + rs(7) + "\n")
    return s + (
        "\nVSG_API int vsg_read_stamps_rs(long long* out) {\n"
        "    return (int)cudaMemcpyFromSymbol(out, g_st_rs, "
        "sizeof(long long) * 2 * 8 * 8);\n}\n")


def make_copy(dst: Path) -> None:
    """The package copied to ``dst`` with the stamps inserted."""
    if dst.exists():
        shutil.rmtree(dst)
    out = dst / PKG.name
    shutil.copytree(PKG, out, ignore=shutil.ignore_patterns("__pycache__"))
    for name, fn in (("sg_assemble.cu", _stamp_k21),
                     ("ransac.cu", _stamp_k13)):
        p = out / "csrc" / name
        p.write_text(fn(p.read_text()))


def _line(tag: str, **kw) -> None:
    print(json.dumps(dict(tag=tag, **kw)), flush=True)


def read() -> None:
    """The stamps of the K21 and K13 launches described above."""
    from visual_sgraphs_tpu_torch import cuda, selfcheck
    from visual_sgraphs_tpu_torch.optim import fast_ba
    from visual_sgraphs_tpu_torch.scenegraph import plane_fit, pointcloud
    lib = cuda.library()
    if not hasattr(lib, "vsg_read_stamps_sg"):
        raise SystemExit("profile_stamps --read: run the stamped copy's "
                         "file by path with PYTHONPATH set to the copy")
    P = ctypes.c_void_p
    lib.vsg_read_stamps_sg.argtypes = [P, P, P]
    lib.vsg_read_stamps_rs.argtypes = [P]
    dev = torch.device("cuda")
    d = selfcheck.sg_assemble_inputs()
    sparse = dict(d)
    keep = np.random.default_rng(4).uniform(size=d["ob_valid"].shape) < 0.1
    sparse["ob_valid"] = d["ob_valid"] & keep
    sparse["quad_valid"] = d["quad_valid"] & keep
    for tag, inputs in (("k21_seeded", d), ("k21_sparse", sparse)):
        poses, planes, rooms, doors, fac, S_kf, rhs_kf = \
            selfcheck.sg_system_args(inputs, dev)
        plan = fast_ba.sg_plan(fac, poses.shape[0], planes.shape[0])

        def fn():
            return fast_ba.sg_system(poses, planes, rooms, doors, fac, plan,
                                     S_kf, rhs_kf)

        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        sys_ = np.zeros(2 * 8 * 2048, np.int64)
        pl = np.zeros(2 * 16, np.int64)
        items = np.zeros(3 * 4096, np.int64)
        if lib.vsg_read_stamps_sg(sys_.ctypes.data, pl.ctypes.data,
                                  items.ctypes.data) != 0:
            raise RuntimeError("profile_stamps: reading K21's stamps failed")
        st = sys_.reshape(2048, 8, 2)
        st = st[st[:, 0, 0] > 0][:, :6]
        gt, ck = st[..., 0], st[..., 1]
        t0 = gt[:, 0].min()
        items = items.reshape(4096, 3)[:int(plan.meta[0])]
        by_type = {}
        for t in range(5):
            it = items[items[:, 0] == t]
            if len(it):
                by_type[t] = dict(n=len(it), lin_median=int(np.median(
                    it[:, 1])), lin_max=int(it[:, 1].max()),
                    write_max=int(it[:, 2].max()))
        pl = pl.reshape(16, 2)[:8]
        _line(tag, ctas=len(st),
              ns_max=[int(gt[:, k].max() - t0) for k in range(6)],
              ns_median=[int(np.median(gt[:, k] - t0)) for k in range(6)],
              cycles_median=[int(np.median(ck[:, k + 1] - ck[:, k]))
                             for k in range(5)],
              cycles_max=[int((ck[:, k + 1] - ck[:, k]).max())
                          for k in range(5)],
              item_cycles=by_type,
              plan_cycles=[int(pl[k + 1, 1] - pl[k, 1]) for k in range(7)],
              device_ms=selfcheck.device_time(fn),
              plan_device_ms=selfcheck.device_time(
                  lambda: fast_ba.sg_plan(fac, poses.shape[0],
                                          planes.shape[0])))
    for frame in (21, 48):
        depth, sem, _, cam_K, hyp = selfcheck.keyframe_inputs(dev, frame)
        t = pointcloud.depth_cloud_torch(depth, sem, None, cam_K, 0.08, 2048)
        args = (t[4], t[5], t[6], hyp, 0.04, 150.0)
        for _ in range(3):
            plane_fit.extract_planes(*args)
        torch.cuda.synchronize()
        rs = np.zeros(2 * 8 * 8, np.int64)
        if lib.vsg_read_stamps_rs(rs.ctypes.data) != 0:
            raise RuntimeError("profile_stamps: reading K13's stamps failed")
        rs = rs.reshape(8, 8, 2)[:hyp.shape[0]]
        _line(f"k13_keyframe{frame}",
              round_cycles=[[int(r[k + 1, 1] - r[k, 1]) for k in range(7)]
                            for r in rs],
              round_ns=[int(r[7, 0] - r[0, 0]) for r in rs],
              device_ms=selfcheck.device_time(
                  lambda: plane_fit.extract_planes(*args)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dir", nargs="?", help="make the stamped copy here")
    ap.add_argument("--read", action="store_true",
                    help="launch and print the stamps (PYTHONPATH set to a "
                    "stamped copy)")
    args = ap.parse_args()
    if args.read:
        if not torch.cuda.is_available():
            raise SystemExit("profile_stamps: torch.cuda.is_available() is "
                             "false")
        read()
    elif args.dir:
        make_copy(Path(args.dir))
    else:
        ap.error("give DIR or --read")


if __name__ == "__main__":
    main()
