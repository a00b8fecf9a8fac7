"""Input normalization constant (reference models/hit_sir_pro.py:1126-1131)."""

IMAGENET_ISH_RGB_MEAN = (0.485, 0.456, 0.4060)
