# -*- coding:utf-8 -*-
