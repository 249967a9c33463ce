"""TinyTrain core: Fisher probe, Eq. 3 selection, sparse fine-tune, and the
host-sync telemetry shared by the adaptation and serving engines."""
