"""The volumes a configuration derives from its emission, one module a
kind, named by the ``kind`` of its ``absorption``, ``reflection``,
``gradient_volumes`` or ``illumination`` entry: ``make(spec, emission,
device)`` returns the volume (the gradient volumes: a tuple of three),
float32 on the device."""
