"""The data pipeline: image folders, transforms, the BSRGAN degradation, the
loader and the copy to the card."""
