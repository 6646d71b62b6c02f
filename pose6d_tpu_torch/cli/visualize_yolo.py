"""The detector's boxes on random test frames, one PNG each (counterpart of
scripts/visualize_yolo.py; the reference's
scripts/visualization/visualize_yolo.py:21-59).

Each test frame is letterboxed to 640 as the detector trains
(data/detection.DetectionLoader), decoded and put through class-aware NMS
(max 10 boxes, top 100 candidates), and every valid box is drawn on the
canvas in green (data/raster.py). Each box's class name and score are
printed (the JAX script writes them on the image with cv2, which the port
does not use).

  python -m pose6d_tpu_torch.cli.visualize_yolo --data-root .../data \\
      --yolo-weights runs/detect/linemod_yolo --out-dir results
"""

import argparse
import os
import sys

import numpy as np
import torch

from pose6d_tpu_torch.cli import add_device_arg

IMG_SIZE = 640


@torch.no_grad()
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--yolo-weights", required=True)
    ap.add_argument("--num-images", type=int, default=4)
    ap.add_argument("--out-dir", default="results")
    ap.add_argument("--seed", type=int, default=0)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from pose6d_tpu_torch.data.detection import DetectionLoader
    from pose6d_tpu_torch.data.png import write_png
    from pose6d_tpu_torch.models.yolo.decode import batched_nms, decode_outputs
    from pose6d_tpu_torch.models.yolo.model import YoloConfig, YoloV8
    from pose6d_tpu_torch.models.yolo.train import load_yolo_variables
    from pose6d_tpu_torch.ops.augment import to_float01
    from pose6d_tpu_torch.utils import draw_rectangle

    loader = DetectionLoader(args.data_root, "test", img_size=IMG_SIZE)
    try:
        if len(loader) == 0:
            sys.exit("no test images")
        ycfg = YoloConfig(num_classes=loader.num_classes)
        state = load_yolo_variables(args.yolo_weights, ycfg)
        if state is None:
            sys.exit(f"no detector checkpoint in {args.yolo_weights}")
        model = YoloV8(ycfg)
        model.load_state_dict(state, strict=True)
        model = model.to(args.device).eval()

        os.makedirs(args.out_dir, exist_ok=True)
        rng = np.random.default_rng(args.seed)
        idxs = rng.choice(len(loader), min(args.num_images, len(loader)), replace=False)
        for i, idx in enumerate(idxs):
            s = loader.load_sample(int(idx))
            image = torch.from_numpy(s["image"])[None].to(args.device)
            boxes, scores = decode_outputs(model(to_float01(image)), ycfg, (IMG_SIZE, IMG_SIZE))
            dets = {k: v[0].cpu().numpy()
                    for k, v in batched_nms(boxes, scores, max_det=10, pre_topk=100).items()}
            canvas = np.ascontiguousarray(s["image"][:, :, ::-1])  # the loader's RGB, as BGR
            out_path = os.path.join(args.out_dir, f"yolo_det_{i}.png")
            for b, c, sc, v in zip(dets["boxes"], dets["classes"], dets["scores"],
                                   dets["valid"]):
                if not v:
                    continue
                x1, y1, x2, y2 = b.astype(int)
                draw_rectangle(canvas, (x1, y1), (x2, y2), (0, 255, 0), 2)
                label = (loader.class_names[int(c)] if 0 <= int(c) < len(loader.class_names)
                         else "?")
                print(f"{out_path}: {label} {sc:.2f} [{x1}, {y1}, {x2}, {y2}]")
            write_png(out_path, np.ascontiguousarray(canvas[:, :, ::-1]))
            print(f"saved {out_path}")
    finally:
        loader.close()


if __name__ == "__main__":
    main()
