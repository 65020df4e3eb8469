"""Configuration, JSON and segmentation helpers of the port."""
