"""The ten assigned architectures at full scale, one module each
(``CONFIG``), copies of the reference's ``repro.configs``; selected through
:func:`repro_torch.models.registry.get_config`."""
