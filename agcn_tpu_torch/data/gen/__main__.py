"""Offline data-generation CLI: `python -m agcn_tpu_torch.data.gen <cmd>`
(port of agcn_tpu/data/gen/__main__.py: the same arguments, defaults and
printed lines).

One entry point for the reference's standalone scripts
(data_gen/ntu_gendata.py, gen_bone_data.py + gen_motion_data.py,
kinetics_gendata.py, the data_gen/sgn/ 3-script chain, and
data_gen/openpose/openpose_b25_j15_ntu_gendata.py):

    python -m agcn_tpu_torch.data.gen ntu --data-path raw/ --out-path out/ \
        --benchmark xsub xview --part train eval
    python -m agcn_tpu_torch.data.gen streams \
        --joint-path out/xview/train_data_joint.npy
    python -m agcn_tpu_torch.data.gen kinetics --data-path kinetics_train/ \
        --label-path kinetics_train_label.json --out-dir out/ --part train
    python -m agcn_tpu_torch.data.gen sgn-raw --stat-dir statistics/ \
        --skeleton-root raw/ --out-dir out_sgn/
    python -m agcn_tpu_torch.data.gen openpose --data-path raw/ \
        --out-path out/ --benchmark xview --part train
    python -m agcn_tpu_torch.data.gen explore --data-path raw/ --classes 7 8 \
        --read-frames --render-sample S001C001P001R001A008.skeleton \
        --save sample.gif   # reference data_gen/ntu_explore.py

`--render-sample` draws with matplotlib (utils/visualization.py).
"""

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m agcn_tpu_torch.data.gen")
    sub = p.add_subparsers(dest="cmd", required=True)

    ntu = sub.add_parser("ntu", help="raw .skeleton -> (N,3,300,25,2) npy")
    ntu.add_argument("--data-path", required=True)
    ntu.add_argument("--out-path", required=True)
    ntu.add_argument("--ignored-sample-path", default=None)
    ntu.add_argument("--benchmark", nargs="+", default=["xsub", "xview"])
    ntu.add_argument("--part", nargs="+", default=["train", "eval"])

    st = sub.add_parser("streams",
                        help="bone/motion streams next to a joint npy")
    st.add_argument("--joint-path", required=True)
    st.add_argument("--skeleton", default="ntu_rgb_d")
    st.add_argument("--no-motion", action="store_true")
    st.add_argument("--out-dir", default=None)

    kin = sub.add_parser("kinetics",
                         help="OpenPose JSON dir -> (N,3,300,18,2) npy")
    kin.add_argument("--data-path", required=True)
    kin.add_argument("--label-path", required=True)
    kin.add_argument("--out-dir", required=True)
    kin.add_argument("--part", nargs="+", default=["train", "val"])

    sgn = sub.add_parser("sgn-raw",
                         help="raw .skeleton + NTU metadata tables -> "
                              "SGN pkl splits (denoising chain)")
    sgn.add_argument("--stat-dir", required=True,
                     help="dir with skes_available_name/label/performer/"
                          "camera/samples_with_missing_skeletons txts")
    sgn.add_argument("--skeleton-root", required=True)
    sgn.add_argument("--out-dir", required=True)
    sgn.add_argument("--evaluations", nargs="+", default=["CS", "CV"])

    op = sub.add_parser("openpose",
                        help="raw .skeleton -> 15-joint NTU-format npy")
    op.add_argument("--data-path", required=True)
    op.add_argument("--out-path", required=True)
    op.add_argument("--ignored-sample-path", default=None)
    op.add_argument("--benchmark", nargs="+", default=["xsub", "xview"])
    op.add_argument("--part", nargs="+", default=["train", "eval"])
    op.add_argument("--subset", action="store_true",
                    help="keep only the 9-class demo label subset")

    ex = sub.add_parser("explore",
                        help="dataset statistics + sample rendering "
                             "(reference data_gen/ntu_explore.py)")
    ex.add_argument("--data-path", required=True,
                    help="raw .skeleton dir OR a generated .npy dataset")
    ex.add_argument("--label-path", default=None,
                    help="label pkl for a .npy dataset")
    ex.add_argument("--benchmark", default="xview",
                    choices=["xview", "xsub"])
    ex.add_argument("--classes", nargs="+", type=int, default=None,
                    help="0-based label subset filter")
    ex.add_argument("--read-frames", action="store_true",
                    help="also parse every raw file for frame/body stats")
    ex.add_argument("--render-sample", default=None,
                    help=".skeleton filename to animate")
    ex.add_argument("--save", default=None,
                    help="gif/mp4 path for --render-sample")

    args = p.parse_args(argv)

    if args.cmd == "ntu":
        from agcn_tpu_torch.data.gen.ntu import gendata

        for b in args.benchmark:
            out = os.path.join(args.out_path, b)
            os.makedirs(out, exist_ok=True)
            for part in args.part:
                print(f"ntu {b} {part}", flush=True)
                gendata(args.data_path, out,
                        ignored_sample_path=args.ignored_sample_path,
                        benchmark=b, part=part)
    elif args.cmd == "streams":
        from agcn_tpu_torch.data.gen.streams import generate_streams

        generate_streams(args.joint_path, args.skeleton,
                         motion=not args.no_motion, out_dir=args.out_dir)
    elif args.cmd == "kinetics":
        from agcn_tpu_torch.data.gen.kinetics import gendata

        os.makedirs(args.out_dir, exist_ok=True)
        for part in args.part:
            print(f"kinetics {part}", flush=True)
            gendata(args.data_path, args.label_path, args.out_dir, part)
    elif args.cmd == "sgn-raw":
        from agcn_tpu_torch.data.gen.sgn_raw import (gendata_from_raw,
                                                     load_statistics)

        paths, labels, performer, camera = load_statistics(
            args.stat_dir, args.skeleton_root)
        os.makedirs(args.out_dir, exist_ok=True)
        gendata_from_raw(paths, labels, performer, camera, args.out_dir,
                         evaluations=args.evaluations)
    elif args.cmd == "openpose":
        from agcn_tpu_torch.data.gen.openpose import LABEL_MAPPING, gendata

        for b in args.benchmark:
            out = os.path.join(args.out_path, b)
            os.makedirs(out, exist_ok=True)
            for part in args.part:
                print(f"openpose {b} {part}", flush=True)
                gendata(args.data_path, out,
                        ignored_sample_path=args.ignored_sample_path,
                        benchmark=b, part=part,
                        label_subset=LABEL_MAPPING if args.subset
                        else None)
    elif args.cmd == "explore":
        from agcn_tpu_torch.data.gen.explore import (explore_npy,
                                                     explore_raw,
                                                     render_sample)

        if args.data_path.endswith(".npy"):
            report = explore_npy(args.data_path, args.label_path,
                                 classes=args.classes)
        else:
            report = explore_raw(args.data_path, benchmark=args.benchmark,
                                 classes=args.classes,
                                 read_frames=args.read_frames)
        for line in report.summary_lines():
            print(line, flush=True)
        if args.render_sample:
            if not args.save:
                p.error("--render-sample requires --save")
            out = render_sample(args.data_path, args.render_sample,
                                args.save)
            print(f"saved {out}", flush=True)


if __name__ == "__main__":
    main()
