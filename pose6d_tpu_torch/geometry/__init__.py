"""Quaternion (xyzw) and pinhole-camera geometry."""
