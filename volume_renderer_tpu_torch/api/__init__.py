"""User-facing session layer (the MATLAB VolumeRender equivalent)."""
