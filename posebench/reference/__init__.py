"""The plain reference of the benchmark's pipelines: float32 PyTorch over a
state dict, with no kernel, no folding and no batching trick. It imports
torch alone: nothing of the program under test, nor of JAX.

    nets.py      YOLOv8 (ultralytics' yolov8.yaml, scale n), ResNet-50 with
                 BatchNorm unfolded, the rgbd fusion and heads, the
                 rgbd_geometric heads
    pipeline.py  frames -> detector maps -> every anchor's box and logit;
                 a box -> square crop -> bilinear resize -> ImageNet and depth
                 normalisation -> PoseNet -> pinhole translation
"""
