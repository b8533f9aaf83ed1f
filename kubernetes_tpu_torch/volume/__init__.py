"""Volume subsystem helpers the scheduler's volume device path reads
(csi_translation, a copy of the reference's). The volume binder comes
with the scheduler loop."""
