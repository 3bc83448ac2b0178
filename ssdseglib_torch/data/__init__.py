"""Input data: synthetic warehouse scenes (`synthetic`) and the host loader with
the device-side batch transform (`pipeline`)."""
