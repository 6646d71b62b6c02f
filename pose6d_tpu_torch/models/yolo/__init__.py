"""YOLOv8 detector and its top-1 decode."""
