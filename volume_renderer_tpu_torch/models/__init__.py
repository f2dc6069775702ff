"""Scene description: volumes, camera, lights, render settings."""
