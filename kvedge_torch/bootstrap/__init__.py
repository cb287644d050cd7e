"""Boot-time bootstrap: execute a ``#kvedge-boot-config`` document.

The port's copy of the JAX package's ``kvedge_tpu/bootstrap/``
(framework-free), booting the port's runtime:

* :mod:`kvedge_torch.bootstrap.bootdoc` — parse the boot-config document;
* :mod:`kvedge_torch.bootstrap.mount` — locate the config volume by serial;
* :mod:`kvedge_torch.bootstrap.commands` — the in-process
  ``kvedge-bootstrap`` / ``kvedge-runtime`` command handlers bootcmd/runcmd
  dispatch to (``kvedge-runtime boot`` starts
  :mod:`kvedge_torch.runtime.boot`);
* :mod:`kvedge_torch.bootstrap.entrypoint` — PID-1 sequencing: parse the
  document, authorize SSH keys, run ``bootcmd`` then ``runcmd`` in order.
"""
