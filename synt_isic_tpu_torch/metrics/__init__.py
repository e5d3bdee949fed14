from .fid import (FeatureExtractor, InceptionFeatureExtractor,
                  PixelFeatureExtractor, compute_fid, default_extractor,
                  frechet_distance, pixel_frechet)

__all__ = ["compute_fid", "frechet_distance", "FeatureExtractor",
           "InceptionFeatureExtractor", "PixelFeatureExtractor",
           "default_extractor", "pixel_frechet"]
