"""Strong-field QED numerics: for photon emission the quantum
synchrotron rate and spectrum sampling (``emission``) over
piecewise-monotone cubic Hermite tables (``pwmci``), with the
reference's tabulated CDFs (``tables_data``, a copy of
``opal_tpu/qed/tables_data.py``); for photon absorption and stimulated
emission the cross sections (``cross_sections``) and the Airy function
they need (``airy``)."""
