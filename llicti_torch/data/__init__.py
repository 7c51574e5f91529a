"""The data pipeline: image directories, synthetic images and loaders."""
from .dataset import (EvalLoader, ImageDataset, TrainLoader, center_crop,
                      list_images, load_rgb, random_patch, synthetic_image,
                      synthetic_natural_image)
